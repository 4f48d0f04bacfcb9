"""Port vs JAX: constant-density media (``intersect`` media fold and record,
``integrator.media_uniforms``, the isotropic scatter), scenes 7 and 8, and
the whole traces of scenes 7, 8 and a mesh scene.

Single operations agree to a few ulps (the port rounds sqrt, sin, cos, log
and cbrt correctly; XLA's are an ulp off on some inputs), so hits and
records are held to rtol 1e-6.  Whole traces use the bar of
tests/test_mega.py:37-45.  Their JAX side runs in a child process whose
XLA:CPU emits no FMA (``--xla_cpu_max_isa=AVX``, ``jax_reference``): under
jit XLA:CPU contracts a*b+c into one FMA, while the port rounds every
operation as its kernels do (built with -fmad=false).  On scene 8
(coordinates ~10^3, a mist 10^4 units across) that contraction alone moves
the reference's segments by up to 1.2% of a sample against its own eager
evaluation, which the port matches exactly.
"""

import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import jax_sphere_record
from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import integrator as jint
from another_raytracer_tpu.ops import intersect as jix
from another_raytracer_tpu.ops import shade as jshade
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import integrator as tint
from another_raytracer_tpu_torch.ops import intersect as tix
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import shade as tshade
from another_raytracer_tpu_torch.ops import vec3 as tv

torch.set_num_threads(1)

W, H, DEPTH = 24, 18, 8
B = 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_reference(script: str, **paths) -> dict:
    """Run ``script`` with the JAX package in a child process whose XLA:CPU
    emits no FMA, and return the arrays it puts in the dict ``out``.
    ``paths`` are bound as names in the script."""
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "out.npz")
        code = "\n".join(
            ["import numpy as np", "import jax",
             "jax.config.update('jax_platforms', 'cpu')",
             "import jax.numpy as jnp", "out = {}"]
            + [f"{k} = {v!r}" for k, v in paths.items()]
            + [script, f"np.savez({npz!r}, **out)"])
        env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=AVX",
                   JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"the JAX child failed:\n{run.stderr[-4000:]}")
        return dict(np.load(npz))


def _jv(a):
    return jv.V3(*(jnp.asarray(c) for c in a))


def _tv(a):
    return tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def forward_bar(got, want, got_segs, want_segs):
    """The bar of tests/test_mega.py:37-45."""
    assert abs(got_segs - want_segs) <= max(4, 0.01 * want_segs), (
        got_segs, want_segs)
    diff_ = np.abs(got - want)
    assert (diff_ > 2e-2).mean() <= 0.02
    assert np.median(diff_) < 1e-5


# --------------------------------------------------------------------------
# Media hits and records
# --------------------------------------------------------------------------


def _media_scene(cls):
    """Every medium case: a sphere medium, a box medium under rotate_y +
    translate, a glass sphere around a medium, a box thinner than
    MEDIUM_REHIT_EPS, and a ground and a light to hit around them."""
    b = cls(background=(0.6, 0.7, 0.9), seed=8)
    b.xz_rect(-20, 20, -20, 20, -1.0, b.lambertian(color=(0.5, 0.5, 0.5)))
    b.xy_rect(-2, 2, 0, 3, -6, b.diffuse_light(color=(3, 3, 3)))
    b.constant_medium_sphere((-1.5, 0.5, -2.0), 0.8, 0.7, color=(0.8, 0.3, 0.3))
    xf = b.transform(rotate_y_deg=27.0, translate=(1.2, -0.5, -2.5))
    b.constant_medium_box((-0.5, 0, -0.5), (0.5, 1.5, 0.5), 1.3,
                          color=(0.3, 0.8, 0.3), xform=xf)
    b.sphere((0.0, 0.3, -4.0), 0.9, b.dielectric(1.5))
    b.constant_medium_sphere((0.0, 0.3, -4.0), 0.9, 2.0, color=(0.2, 0.4, 0.9))
    b.constant_medium_box((-1.0, 1.6, -3.0), (1.0, 1.6 + 5e-5, -1.0), 50.0,
                          color=(1, 1, 1))
    return b.build(), dict(lookfrom=(0, 1, 2), lookat=(0, 0.3, -2.5),
                           vfov=70.0)


def _media_rays(seed=0):
    """Camera rays, rays from inside each medium and random rays; uniforms
    with zeros (log(0) rejects) and values next to 1."""
    rng = np.random.default_rng(seed)
    ref, params = _media_scene(JBuilder)
    port = tscene.scene_from_reference(ref, device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    pix = rng.integers(0, W * H, B)
    o, d, t = tcam.generate_rays(cam, torch.from_numpy(pix),
                                 torch.zeros(B, dtype=torch.int64), W, H, 1)
    o, d, t = tv.to_numpy(o), tv.to_numpy(d), t.numpy()
    q = B // 4
    centers = np.array([(-1.5, 0.5, -2.0), (1.2, 0.2, -2.5), (0.0, 0.3, -4.0),
                        (0.0, 1.6, -2.0)])
    o[q:2 * q] = centers[rng.integers(0, 4, q)] + rng.uniform(-0.3, 0.3, (q, 3))
    o[2 * q:] = rng.uniform((-3, -0.5, -6), (3, 3, 1), (B - 2 * q, 3))
    d[q:] = rng.normal(size=(B - q, 3)) * rng.uniform(0.3, 3.0, (B - q, 1))
    u = rng.uniform(0, 1, (B, ref.n_media))
    u[:32] = 0.0
    u[32:64] = 1.0 - rng.uniform(0, 1e-6, (32, ref.n_media))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    return ref, port, f32(o.T), f32(d.T), f32(t), f32(u)


@pytest.mark.parametrize("t_min", [1e-3, 0.5])
def test_media_hits_and_records_match_jax(t_min):
    ref, port, o, d, t, u = _media_rays()
    assert port.n_media == 4
    jt, jk, ji = jix.closest_hit(ref, _jv(o), _jv(d), jnp.asarray(t),
                                 jnp.asarray(u), t_min)
    with torch.no_grad():
        tt, tk, ti = tix.closest_hit(port, _tv(o), _tv(d), torch.from_numpy(t),
                                     torch.from_numpy(u), t_min)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    medium = np.asarray(jk) == tscene.PRIM_MEDIUM
    # Every medium wins somewhere but the box thinner than
    # MEDIUM_REHIT_EPS (the reference's second probe misses it), and a
    # uniform of 0 never scatters.
    assert set(np.asarray(ji)[medium]) == {0, 1, 2}
    assert medium[:32].sum() == 0
    hit = np.asarray(jk) >= 0
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6, atol=1e-5)

    jrec = jix.make_hit_record(ref, _jv(o), _jv(d), jnp.asarray(t), jt, jk, ji,
                               u_media=jnp.asarray(u), t_min=t_min)
    trec = tix.make_hit_record(port, _tv(o), _tv(d), torch.from_numpy(t), tt,
                               tk, ti, torch.from_numpy(u), t_min=t_min)
    for field in ("t", "u", "v", "tu", "tv"):
        np.testing.assert_allclose(getattr(trec, field).numpy()[hit],
                                   np.asarray(getattr(jrec, field))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=field)
    for field in ("p", "normal"):
        np.testing.assert_allclose(tv.to_numpy(getattr(trec, field))[hit],
                                   jv.to_numpy(getattr(jrec, field))[hit],
                                   rtol=1e-6, atol=1e-5, err_msg=field)
    np.testing.assert_array_equal(trec.mat.numpy()[hit],
                                  np.asarray(jrec.mat)[hit])
    np.testing.assert_array_equal(trec.front_face.numpy()[hit],
                                  np.asarray(jrec.front_face)[hit])
    assert trec.front_face.numpy()[medium].all()
    # The record's t is the selection's t: the recompute clamps the entry
    # to the same t_min (tests/test_scenes.py:76).
    np.testing.assert_allclose(trec.t.numpy()[medium], tt.numpy()[medium],
                               rtol=1e-6)
    assert float(trec.t[torch.from_numpy(medium)].min()) >= t_min


def test_medium_record_threads_t_min():
    """A ray starting inside a box medium: its entry is behind it, so the
    record's entry clamp is the configured t_min (the case of
    tests/test_scenes.py:76)."""
    b = tscene.SceneBuilder()
    b.constant_medium_box((0, 0, 0), (1, 1, 1), density=10.0, color=(1, 1, 1))
    scene = b.build(device="cpu")
    n = 4
    o = tv.V3(*(torch.full((n,), 0.5) for _ in range(3)))
    d = tv.V3(torch.ones(n), torch.zeros(n), torch.zeros(n))
    time = torch.zeros(n)
    u = torch.full((n, 1), 0.7)
    t, kind, idx = tix.closest_hit(scene, o, d, time, u, 0.25)
    assert bool((kind == tscene.PRIM_MEDIUM).all())
    rec = tix.make_hit_record(scene, o, d, time, t, kind, idx, u, t_min=0.25)
    np.testing.assert_allclose(rec.t.numpy(), t.numpy(), rtol=1e-6)
    assert float(rec.t.min()) >= 0.25


def test_media_uniforms_bit_equal():
    ref, port, *_ = _media_rays()
    rng = np.random.default_rng(3)
    pix = rng.integers(0, 1 << 32, B, dtype=np.uint64)
    samp = rng.integers(0, 1 << 20, B, dtype=np.uint64)
    for bounce in (0, 7, 49):
        want = jint._media_uniforms(ref, jnp.asarray(pix, jnp.uint32),
                                    jnp.asarray(samp, jnp.uint32), bounce,
                                    jnp.uint32(11))
        got = tint.media_uniforms(port, torch.from_numpy(pix.astype(np.int64)),
                                  torch.from_numpy(samp.astype(np.int64)),
                                  bounce, 11)
        assert got.shape == (B, 4) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = tint.media_uniforms(tlib.cornell_box(device="cpu")[0],
                                torch.arange(5), torch.zeros(5, dtype=torch.int64),
                                0, 1)
    assert empty.shape == (5, 0)


def _shading_scene(cls):
    """Isotropic media beside metal (the two share the unit-ball point),
    lambertian, dielectric and a light, and a noise-textured medium."""
    b = cls(seed=4)
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.4))
    b.sphere((1, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.xy_rect(-3, 3, 0, 2, -3, b.diffuse_light(color=(4, 4, 4)))
    b.constant_medium_sphere((0, 1, -1), 0.4, 0.5, color=(0.9, 0.5, 0.1))
    b.constant_medium_box((-1, -1, -2), (1, 0, 0), 0.5,
                          texture=b.noise_texture(3.0))
    return b.build()


def test_isotropic_scatter_matches_jax():
    ref = _shading_scene(JBuilder)
    port = tscene.scene_from_reference(ref, device="cpu")
    rng = np.random.default_rng(6)
    n = rng.normal(size=(3, B))
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    p = rng.uniform(-1, 1, (3, B)).astype(np.float32)
    d = rng.normal(size=(3, B)).astype(np.float32)
    mats = rng.integers(0, ref.mat_kind.shape[0], B)
    front = rng.uniform(size=B) < 0.5
    uv = [rng.uniform(0, 1, B).astype(np.float32) for _ in range(2)]
    jrec = jix.HitRecord(t=jnp.ones(B), p=_jv(p), normal=_jv(n),
                         front_face=jnp.asarray(front),
                         mat=jnp.asarray(mats, jnp.int32), u=jnp.asarray(uv[0]),
                         v=jnp.asarray(uv[1]), tu=jnp.asarray(uv[0]),
                         tv=jnp.asarray(uv[1]))
    trec = tix.HitRecord(t=torch.ones(B), p=_tv(p), normal=_tv(n),
                         front_face=torch.from_numpy(front),
                         mat=torch.from_numpy(mats), u=torch.from_numpy(uv[0]),
                         v=torch.from_numpy(uv[1]), tu=torch.from_numpy(uv[0]),
                         tv=torch.from_numpy(uv[1]))
    pix, samp = np.arange(B), np.full(B, 5)
    jout = jshade.emit_and_scatter(ref, jrec, _jv(d), jnp.asarray(pix, jnp.uint32),
                                   jnp.asarray(samp, jnp.uint32), jnp.uint32(3),
                                   jnp.uint32(9))
    tout = tshade.emit_and_scatter(port, trec, _tv(d), torch.from_numpy(pix),
                                   torch.from_numpy(samp), 3, 9)
    iso = np.asarray(ref.mat_kind)[mats] == tscene.MAT_ISOTROPIC
    assert iso.sum() > 100
    np.testing.assert_allclose(tv.to_numpy(tout[1]), jv.to_numpy(jout[1]),
                               rtol=1e-6, atol=1e-6)
    # The isotropic direction is a point in the unit ball.
    assert (np.linalg.norm(tv.to_numpy(tout[1])[iso], axis=1) <= 1.0).all()
    np.testing.assert_allclose(tv.to_numpy(tout[2]), jv.to_numpy(jout[2]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tv.to_numpy(tout[2])[iso],
                                  jv.to_numpy(jout[2])[iso])
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tv.to_numpy(tout[0]), jv.to_numpy(jout[0]))


# --------------------------------------------------------------------------
# Gradients of the media leaves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", ["med_a", "med_b", "med_neg_inv_density"])
def test_media_record_gradients_match_jax(leaf):
    """Through the winner recompute (the hit point and t of every lane),
    against jax.grad; no masked lane may make them NaN."""
    ref, port, o, d, t, u = _media_rays(seed=1)
    w = np.random.default_rng(5).uniform(0.2, 1.0, (4, B)).astype(np.float32)
    jt, jk, ji = jix.closest_hit(ref, _jv(o), _jv(d), jnp.asarray(t),
                                 jnp.asarray(u), 1e-3)

    def jloss(x):
        rec = jix.make_hit_record(ref.replace(**{leaf: x}), _jv(o), _jv(d),
                                  jnp.asarray(t), jt, jk, ji,
                                  u_media=jnp.asarray(u), t_min=1e-3)
        parts = (*rec.p, rec.t)
        return sum(jnp.sum(c * jnp.asarray(wc)) for c, wc in zip(parts, w))

    want = np.asarray(jax.grad(jloss)(getattr(ref, leaf)))
    with torch.no_grad():
        tt, tk, ti = tix.closest_hit(port, _tv(o), _tv(d), torch.from_numpy(t),
                                     torch.from_numpy(u), 1e-3)
    x = getattr(port, leaf).clone().requires_grad_(True)
    rec = tix.make_hit_record(port.replace(**{leaf: x}), _tv(o), _tv(d),
                              torch.from_numpy(t), tt, tk, ti,
                              torch.from_numpy(u), t_min=1e-3)
    parts = (*rec.p, rec.t)
    loss = sum((c * torch.from_numpy(wc)).sum() for c, wc in zip(parts, w))
    (got,) = torch.autograd.grad(loss, [x])
    assert torch.isfinite(got).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def _noise_medium(cls):
    """A noise-textured isotropic medium lit from above: the albedo at the
    scatter point makes the radiance smooth in the density and the
    boundary."""
    b = cls(background=(0.0, 0.0, 0.0), seed=12)
    b.xz_rect(-30, 30, -30, 30, 6, b.diffuse_light(color=(2, 2, 2)))
    b.constant_medium_box((-3, -2, -6), (3, 2, -2), 0.4,
                          texture=b.noise_texture(1.3))
    b.xz_rect(-30, 30, -30, 30, -2.5, b.lambertian(color=(0.6, 0.6, 0.6)))
    return b.build(device="cpu") if cls is tscene.SceneBuilder else b.build()


@functools.lru_cache(maxsize=None)
def _noise_medium_case():
    ref = _noise_medium(JBuilder)
    params = dict(lookfrom=(0.1, 0.3, 2), lookat=(0, 0, -4), vfov=50.0)
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    target = np.random.default_rng(2).uniform(0, 0.5, (W * H, 3)).astype(np.float32)
    kw = dict(width=W, height=H, spp=1, samples_per_pass=1, max_depth=4,
              t_min=1e-3)
    leaves = {k: getattr(ref, k) for k in ("med_neg_inv_density", "med_a")}
    loss, grads = jax.value_and_grad(jdiff.render_loss)(
        leaves, ref, ref_cam, jnp.asarray(target), jnp.uint32(3), **kw)
    return params, target, kw, float(loss), {k: np.asarray(g)
                                             for k, g in grads.items()}


def test_whole_trace_media_gradients_match_jax():
    """render_loss through the lockstep autograd path (media never take the
    fused path) against jax.value_and_grad."""
    params, target, kw, loss_w, grads_w = _noise_medium_case()
    port = _noise_medium(tscene.SceneBuilder)
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    leaves = {k: getattr(port, k) for k in grads_w}
    loss_g, grads_g = diff.render_value_and_grad(
        leaves, port, cam, torch.from_numpy(target), 3, **kw)
    np.testing.assert_allclose(float(loss_g), loss_w, rtol=1e-5)
    for k, want in grads_w.items():
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads_g[k].numpy(), want, rtol=2e-4,
                                   atol=2e-4 * scale, err_msg=k)


def test_scene7_density_gradient_matches_jax():
    """Scene 7's densities through render_loss, as chip_smoke.py's gradient
    step takes them: its media have solid albedos and isotropic directions
    that do not depend on the scatter point, so the radiance is piecewise
    constant in the densities and both packages give an exact zero."""
    kw = dict(width=W, height=H, spp=2, samples_per_pass=1, max_depth=6,
              t_min=1e-3)
    target = np.random.default_rng(0).uniform(0, 0.5, (W * H, 3)).astype(
        np.float32)
    ref, params = jlib.cornell_smoke()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    loss_w, grads_w = jax.value_and_grad(jdiff.render_loss)(
        {"med_neg_inv_density": ref.med_neg_inv_density}, ref, ref_cam,
        jnp.asarray(target), jnp.uint32(1), **kw)
    port, params = tlib.cornell_smoke(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    loss_g, grads_g = diff.render_value_and_grad(
        {"med_neg_inv_density": port.med_neg_inv_density}, port, cam,
        torch.from_numpy(target), 1, **kw)
    np.testing.assert_allclose(float(loss_g), float(loss_w), rtol=1e-5)
    want = np.asarray(grads_w["med_neg_inv_density"])
    assert not want.any()
    np.testing.assert_array_equal(grads_g["med_neg_inv_density"].numpy(),
                                  want)


# --------------------------------------------------------------------------
# Scenes 7, 8 and a mesh scene
# --------------------------------------------------------------------------


@pytest.mark.parametrize("alias", [7, 8])
def test_scene_fields_match_jax(alias):
    ref, rparams = jlib.build(alias)
    port, params = tlib.build(alias, device="cpu")
    assert params == rparams
    for name, value in port.tensors().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in tscene.STATIC_FIELDS:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.n_media == 2


@pytest.fixture(scope="module")
def capsule(tmp_path_factory):
    """A small textured capsule mesh (16 x 9 quads, 288 triangles: a BVH)."""
    return chip_smoke.write_capsule(str(tmp_path_factory.mktemp("mesh")),
                                    segments=16, rings=9, texels=16)


def _scene(name, obj):
    if name == "mesh":
        return tlib.mesh_scene(obj_path=obj, device="cpu")
    return getattr(tlib, name)(device="cpu")


SCENES = ["cornell_smoke", "final_scene", "mesh"]


@pytest.fixture(scope="module")
def jax_traces(capsule):
    """JAX's lockstep trace (sample 0) and regenerating wavefront (samples 0
    and 1 per lane) of each scene, computed without FMA, with the port's
    re-projection of sphere hits (``jax_sphere_record``)."""
    return jax_reference(jax_sphere_record.SNIPPET + f"""
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.ops import camera as jcam, integrator as jint
from another_raytracer_tpu.ops import vec3 as jv
W, H, DEPTH = {W}, {H}, {DEPTH}
for name in {SCENES!r}:
    sc, p = (jlib.mesh_scene(obj_path=obj) if name == "mesh"
             else getattr(jlib, name)())
    cam = jcam.make_camera(aspect_ratio=W / H, **p)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    samp = jnp.zeros(W * H, jnp.uint32)
    o, d, t = jcam.generate_rays(cam, pix, samp, W, H, jnp.uint32(3),
                                 needs_time=sc.has_motion)
    r, s = jint.trace(sc, o, d, t, pix, samp, jnp.uint32(3), DEPTH, 1e-3)
    out[name + "_trace"], out[name + "_trace_segs"] = jv.to_numpy(r), int(s)
    r, s = jint.trace_regenerative(
        sc, cam, pix, samp, jnp.uint32(3), width=W, height=H, sample_stride=1,
        sample_end=2, spp_cap=2, max_depth=DEPTH, t_min=1e-3)
    out[name + "_regen"], out[name + "_regen_segs"] = jv.to_numpy(r), int(s)
""", obj=capsule)


@pytest.mark.parametrize("name", SCENES)
def test_scene_traces_match_jax(name, capsule, jax_traces, monkeypatch):
    """``trace`` and ``trace_regenerative`` against JAX's within the bar;
    the wavefront bit-equal to the lockstep loop at samples_per_pass 1,
    with the staged compaction forced to narrow stages."""
    scene, params = _scene(name, capsule)
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    n = W * H
    pix, samp = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    o, d, t = tcam.generate_rays(cam, pix, samp, W, H, 3,
                                 needs_time=scene.has_motion)
    with torch.no_grad():
        got, segs = tint.trace(scene, o, d, t, pix, samp, 3, DEPTH, 1e-3)
    forward_bar(tv.to_numpy(got), jax_traces[name + "_trace"], int(segs),
                int(jax_traces[name + "_trace_segs"]))

    monkeypatch.setattr(tint, "REGEN_COMPACT_MIN_B", 64)
    assert len(tint._stage_widths(n)) > 1
    got, segs = tint.trace_regenerative(
        scene, cam, pix, samp, 3, width=W, height=H, sample_stride=1,
        sample_end=2, spp_cap=2, max_depth=DEPTH, t_min=1e-3)
    forward_bar(tv.to_numpy(got), jax_traces[name + "_regen"], int(segs),
                int(jax_traces[name + "_regen_segs"]))
    with torch.no_grad():
        lock, lock_segs = trender.radiance_batch(
            scene, cam, pix, 3, width=W, height=H, sample_start=0,
            n_samples=2, spp_cap=2, samples_per_pass=1, max_depth=DEPTH,
            t_min=1e-3, differentiable=True)
    np.testing.assert_array_equal(tv.to_numpy(got), tv.to_numpy(lock))
    assert int(segs) == int(lock_segs)


def test_scene_renders_through_the_wavefront(capsule, monkeypatch):
    """Forward renders of media and triangle scenes take the wavefront (the
    megakernel refuses them), differentiable ones the lockstep loop."""
    calls = []
    real = tint.trace_regenerative
    monkeypatch.setattr(tint, "trace_regenerative",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for name in SCENES:
        scene, params = _scene(name, capsule)
        cam = tcam.make_camera(aspect_ratio=1.0, device="cpu", **params)
        cfg = RenderConfig(width=12, height=12, samples_per_pixel=1,
                           max_depth=3, seed=1)
        img, stats = trender.render(scene, cam, cfg)
        assert img.shape == (12, 12, 3) and stats["segments"] > 0
    assert len(calls) == len(SCENES)
