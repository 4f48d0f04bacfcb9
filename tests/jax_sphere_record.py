"""The JAX package's gathered sphere record (``ops/intersect.py``
``_sphere_record``, on its lockstep and wavefront paths) with the port's
re-projection of the hit point onto its sphere
(``another_raytracer_tpu_torch/ops/intersect.py``), for the tests that hold
the port's records, traces and gradients against JAX's on sphere scenes.

The JAX package's files stay as they are: ``reprojecting(real)`` wraps the
module's function, and the fixture ``jax_reprojects_spheres`` (imported by
the tests that take it) puts the wrapper in place for a test; a script run
in a child process (``test_torch_media.jax_reference``) starts with
``SNIPPET``, which does the same there.  The wrapper recomputes the record's
object-space offset from the centre with the record's own operations, moves
the point and the normal as the port does, and takes the UV of the moved
normal from the JAX package's own code (``_sphere_record_aux``, which
computes the spherical UV of the normal it is given).

The JAX package's Pallas megakernel writes its sphere point and normal
inline, where no wrapper reaches them.  The tests that hold the port's
megakernel (its plain version, K1's and K3's, and their record instances)
against it, or against a JAX path that takes sphere hits as ``o + t d``,
take the port's re-projection out instead: ``megakernel_as_jax()``
(and the fixture ``megakernel_like_jax``) puts
``jax_kernel_winner`` in place of the megakernel's ``_onto_winner``."""

import contextlib

import jax
import jax.numpy as jnp
import pytest

SNIPPET = ("import sys\nsys.path.insert(0, 'tests')\n"
           "import jax_sphere_record\njax_sphere_record.install()\n")

# For a child script, before its first computation: XLA without its
# algebraic rewrites (a quotient by a constant or a square root taken as a
# product with a rounded reciprocal), so each operation rounds as written,
# as the port's do, as the children's ``--xla_cpu_max_isa=AVX`` keeps FMA
# out.  Where a point lies on its sphere to the last bits, a grazing
# scatter's next hit turns on those bits.
EXACT_XLA = ("import os\nos.environ['XLA_FLAGS'] = os.environ.get("
             "'XLA_FLAGS', '') + ' --xla_disable_hlo_passes=algsimp'\n")


def onto_sphere(off, r):
    """The port's ``intersect._onto_sphere`` in jnp."""
    from another_raytracer_tpu.ops.vec3 import V3

    fits = ((jnp.abs(off.x) < 1e18) & (jnp.abs(off.y) < 1e18)
            & (jnp.abs(off.z) < 1e18))
    safe = V3(*(jnp.where(fits, c, 1.0) for c in off))
    len2 = safe.x * safe.x + safe.y * safe.y + safe.z * safe.z
    ok = fits & (len2 > 0.0)
    # The barrier keeps XLA from taking the quotient by a square root as a
    # product with an approximate reciprocal square root: the port's
    # quotient is correctly rounded, and the approximation moves a point on
    # a radius of 1,000 by up to ~1e-4, inside, where its scatters meet the
    # sphere again (two_perlin_spheres: 4,105 segments against the port's
    # 4,037 without it, the same count with it).
    root = jax.lax.optimization_barrier(jnp.sqrt(jnp.where(ok, len2, 1.0)))
    scale = jnp.abs(r) / root
    return V3(*(jnp.where(ok, s * scale, c) for s, c in zip(safe, off)))


def reprojecting(real):
    """``real`` (JAX's ``_sphere_record``) with the re-projection."""
    from another_raytracer_tpu.ops import intersect as jix
    from another_raytracer_tpu.ops import vec3 as jvec3

    def record(scene, o, d, time, t, idx):
        t, p, _, mat, _, _, _, _ = real(scene, o, d, time, t, idx)
        ii = jnp.clip(idx, 0, scene.n_spheres - 1)
        o_b, d_b, rows, tr = jix._ray_to_object_gathered(
            scene, scene.sph_xf[ii], o, d)
        c0, c1 = jix._col3(scene.sph_c0, ii), jix._col3(scene.sph_c1, ii)
        t0, t1, r = scene.sph_t0[ii], scene.sph_t1[ii], scene.sph_r[ii]
        center = c0 + (c1 - c0) * ((time - t0) / (t1 - t0))
        off = o_b + d_b * t - center
        on = onto_sphere(off, r)
        n_obj = on * (1.0 / r)
        # The record's UV stops its gradient at the normal; the aux record
        # gives JAX's UV of the normal it is handed.
        _, _, _, _, u, v, _, _ = jix._sphere_record_aux(
            scene, o, d, t, (jax.lax.stop_gradient(n_obj),
                             mat.astype(t.dtype), scene.sph_has_uv[ii]))
        if scene.xf_rot.shape[0] == 1:
            p = p + (on - off)
        else:
            p = jvec3.rotate(rows, center + on) + tr
        return t, p, jvec3.rotate(rows, n_obj), mat, u, v, u, v

    return record


def install():
    """Put the wrapper in place for the rest of the process."""
    from another_raytracer_tpu.ops import intersect as jix

    jix._sphere_record = reprojecting(jix._sphere_record)


@pytest.fixture
def jax_reprojects_spheres(monkeypatch):
    """``reprojecting`` in place of JAX's ``_sphere_record`` for the test;
    JAX's caches are cleared on both sides of it, so no trace of one kind
    serves the other."""
    from another_raytracer_tpu.ops import intersect as jix

    jax.clear_caches()
    monkeypatch.setattr(jix, "_sphere_record",
                        reprojecting(jix._sphere_record))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def jax_kernel_winner(o, d, t, center, rad, inv_r):
    """The megakernel's sphere winner as the JAX kernel takes it: the point
    ``o + d t`` and the normal ``(o + d t - c) * inv_r``, not re-projected
    (the port's ``mega_kernel._onto_winner`` without ``_onto_sphere``)."""
    p = o + d * t
    return (p - center) * inv_r, p


@contextlib.contextmanager
def megakernel_as_jax():
    """``jax_kernel_winner`` in the port's megakernel inside the block."""
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    with pytest.MonkeyPatch.context() as m:
        m.setattr(mega_kernel, "_onto_winner", jax_kernel_winner)
        yield


@pytest.fixture
def megakernel_like_jax():
    """``megakernel_as_jax()`` for the test."""
    with megakernel_as_jax():
        yield
