"""Port vs JAX: the BVH host build, the packers, the builder's BVH branch, the
plain version of the BVH closest-hit kernel K5 (``ops.bvh.traverse_packed``,
reached through the wrapper ``bvh_closest_hit`` on CPU tensors) and the BVH
and triangle parts of ``intersect``.

The plain K5 is held against the Pallas kernel in interpret mode and against
the JAX package's XLA traversal, for every primitive kind and fold variant:
hit mask and code equal on every lane, t to rtol 2e-5 (as
tests/test_pallas_bvh.py:57-61), fold outputs to atol 1e-5.  The Pallas
kernel walks the tree with one cursor per block of rays; the plain version
(and the CUDA kernel) one walk per ray.  Equal winners on every lane show
that the per-ray walk tests the same primitives in the same order.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import bvh as jbvh
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import bvh as jbvh_ops
from another_raytracer_tpu.ops import intersect as jix
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu.ops.pallas import bvh_kernel as jbk
from another_raytracer_tpu_torch.models import bvh as tbvh
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import bvh as tbvh_ops
from another_raytracer_tpu_torch.ops import intersect as tix
from another_raytracer_tpu_torch.ops import vec3 as tv
from another_raytracer_tpu_torch.ops.kernels import bvh_kernel as tbk

torch.set_num_threads(1)

B = 256
LEAF = 8
BIG = 3e37


def _jv3(a):
    return jv.V3(*(jnp.asarray(c) for c in a))


def _tv3(a):
    return tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _triangles(n, rng):
    base = rng.uniform(-5, 5, (n, 3))
    v0, v1, v2 = (base, base + rng.uniform(-0.6, 0.6, (n, 3)),
                  base + rng.uniform(-0.6, 0.6, (n, 3)))
    uvs = [rng.uniform(0, 1, (n, 2)) for _ in range(3)]
    mats = rng.integers(0, 5, n)
    return (v0, v1, v2), uvs, mats


def _spheres(n, rng):
    # Radii near the distance to the rays' origins: the outward normal
    # (o - c + t d) / r cancels ~|o - c| / r digits, and the JAX package's
    # arithmetic (XLA contracts a*b+c into FMA) rounds otherwise than the
    # port's unfused operations, so far-away small spheres would differ by
    # more than the fold tolerance for reasons of conditioning alone.
    c0 = rng.uniform(-5, 5, (n, 3))
    c1 = c0 + np.where(rng.random((n, 1)) < 0.5, 0.0,
                       rng.uniform(-0.4, 0.4, (n, 3)))
    r = rng.uniform(1.0, 2.0, n) * np.where(rng.random(n) < 0.1, -1.0, 1.0)
    t0, t1 = np.zeros(n), np.ones(n)
    return c0, c1, t0, t1, r, rng.integers(0, 7, n), (rng.random(n) < 0.5) * 1.0


def _rects(n, rng):
    axis = rng.integers(0, 3, n)
    k = rng.uniform(-5, 5, n)
    lo = rng.uniform(-5, 4, (n, 2))
    hi = lo + rng.uniform(0.2, 1.5, (n, 2))
    return axis, k, lo, hi


def _packed(prim, pack_mod, bvh_mod, rng, full=True):
    """(nodes, rows) from a package's build + packers on the same inputs."""
    if prim == "planar":
        (v0, v1, v2), uvs, mats = _triangles(200, rng)
        tree = bvh_mod.build(*bvh_mod.triangle_bounds(v0, v1, v2), leaf_size=LEAF)
        codes = np.arange(200) * 4 + 2
        if not full:
            return pack_mod.pack_planar(tree, v0, v1, v2, codes)
        return pack_mod.pack_planar(tree, v0, v1, v2, codes, uv0=uvs[0],
                                    uv1=uvs[1], uv2=uvs[2], mats=mats)
    if prim == "sphere":
        c0, c1, t0, t1, r, mats, has_uv = _spheres(150, rng)
        tree = bvh_mod.build(*bvh_mod.sphere_bounds(c0, c1, r, t0, t1),
                             leaf_size=LEAF)
        return pack_mod.pack_spheres(tree, c0, c1, t0, t1, r, mats=mats,
                                     has_uv=has_uv)
    axis, k, lo, hi = _rects(100, rng)
    tree = bvh_mod.build(*bvh_mod.rect_bounds(axis, k, lo, hi), leaf_size=LEAF)
    return pack_mod.pack_rects(tree, axis, k, lo, hi, np.arange(100) * 4 + 1)


@pytest.mark.parametrize("prim,full", [("planar", True), ("planar", False),
                                       ("sphere", False), ("rect", False)])
def test_build_and_packers_equal_jax(prim, full):
    nodes_j, rows_j = _packed(prim, jbk, jbvh, np.random.default_rng(1), full)
    nodes_t, rows_t = _packed(prim, tbk, tbvh, np.random.default_rng(1), full)
    for a, b in ((nodes_t, nodes_j), (rows_t, rows_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tree_j = jbvh.build(*jbvh.triangle_bounds(*_triangles(77, np.random.default_rng(2))[0]))
    tree_t = tbvh.build(*tbvh.triangle_bounds(*_triangles(77, np.random.default_rng(2))[0]))
    for f in dataclasses.fields(tbvh.FlatBVH):
        np.testing.assert_array_equal(getattr(tree_t, f.name),
                                      getattr(tree_j, f.name))


# --------------------------------------------------------------------------
# The builder's BVH branch
# --------------------------------------------------------------------------


def _sheet(builder_cls, n=8, textured=True):
    """The 128-triangle bumpy sheet of __graft_entry__.py:36-60, with a
    barycentric and an image texture (generated texels) on its halves."""
    b = builder_cls(background=jlib.SKY)
    if textured:
        texels = np.random.default_rng(4).uniform(0, 1, (6, 9, 3))
        mats = (b.lambertian(texture=b.barycentric_texture((1, 0, 0), (0, 1, 0),
                                                           (0, 0, 1))),
                b.lambertian(texture=b.image_texture(texels)))
    else:
        mats = (b.lambertian(color=(0.6, 0.6, 0.6)),) * 2
    for i in range(n):
        for j in range(n):
            def pt(ii, jj):
                x = -1.0 + 2.0 * ii / n
                z = -2.0 - 2.0 * jj / n
                return (x, 0.15 * math.sin(3.0 * x + 2.0 * z), z)

            p00, p10, p01, p11 = pt(i, j), pt(i + 1, j), pt(i, j + 1), pt(i + 1, j + 1)
            uv = ((i / n, j / n), ((i + 1) / n, j / n), ((i + 1) / n, (j + 1) / n))
            m = mats[(i + j) % 2]
            b.triangle(p00, p10, p11, m, uvs=uv)
            b.triangle(p00, p11, p01, m, uvs=uv)
    b.xz_rect(-2, 2, -4, 0, 2.5, b.diffuse_light(color=(3, 3, 3)))
    cam = dict(lookfrom=(0, 1.2, 1.0), lookat=(0, 0, -3), vfov=55.0)
    return b, cam


def _rect_field(builder_cls):
    """80 rects: 60 identity ones (the native rect tree) and 20 transformed
    ones (quad-split into the planar tree), with a sphere in the sweep."""
    rng = np.random.default_rng(8)
    b = builder_cls(background=(0.3, 0.4, 0.5))
    mats = [b.lambertian(color=tuple(rng.uniform(0.2, 0.9, 3))) for _ in range(4)]
    for i in range(60):
        x, z = rng.uniform(-4, 4, 2)
        add = (b.xz_rect, b.xy_rect, b.yz_rect)[i % 3]
        add(x, x + rng.uniform(0.3, 1.0), z, z + rng.uniform(0.3, 1.0),
            rng.uniform(-3, 0), mats[i % 4])
    for i in range(20):
        xf = b.transform(rotate_y_deg=float(rng.uniform(-40, 40)),
                         translate=tuple(rng.uniform(-2, 2, 3)))
        b.xy_rect(-0.5, 0.5, -0.5, 0.5, 0.0, mats[i % 4], xform=xf)
    b.sphere((0, -1000, 0), 996, mats[0])
    cam = dict(lookfrom=(0, 2, 8), lookat=(0, -1, 0), vfov=50.0)
    return b, cam


def _sphere_field(builder_cls):
    """80 spheres (a sphere tree), some moving, one instanced; radii near the
    rays' distance, as in ``_spheres``."""
    rng = np.random.default_rng(6)
    b = builder_cls(background=(0.6, 0.7, 0.9), seed=3)
    mats = [b.lambertian(color=(0.8, 0.3, 0.3)), b.metal((0.8, 0.8, 0.8), 0.2),
            b.dielectric(1.5),
            b.lambertian(texture=b.checker_texture((0.1, 0.1, 0.1), (0.9, 0.9, 0.9)))]
    b.sphere((0, -1000, 0), 999, mats[3])
    for i in range(78):
        c = rng.uniform(-5, 5, 3)
        if i % 5 == 0:
            b.moving_sphere(c, c + (0, 0.3, 0), 0.0, 1.0, 1.2, mats[i % 3])
        else:
            b.sphere(c, 1.2, mats[i % 3])
    xf = b.transform(rotate_y_deg=30, translate=(0.5, 0, 0))
    b.sphere((0, 0, 0), 0.5, mats[0], xform=xf)
    cam = dict(lookfrom=(0, 3, 8), lookat=(0, 0, 0), vfov=40.0, time0=0.0,
               time1=1.0)
    return b, cam


def _assert_scene_equal(port, ref):
    for f in dataclasses.fields(tscene.SceneData):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in tscene.STATIC_FIELDS:
            assert got == want, f.name
        else:
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


@pytest.mark.parametrize("name", ["random", "sheet", "rects"])
def test_builder_bvh_fields_equal_jax(name):
    if name == "random":
        ref, _ = jlib.random_scene()
        port, _ = tlib.random_scene(device="cpu")
        assert port.sph_in_bvh and port.n_sph_bvh_nodes > 0
    elif name == "sheet":
        ref = _sheet(JBuilder)[0].build(bvh=True)
        port = _sheet(tscene.SceneBuilder)[0].build(device="cpu", bvh=True)
        assert port.tri_in_bvh and port.bvh_packed_tris.shape[1] == 35
    else:
        ref = _rect_field(JBuilder)[0].build()
        port = _rect_field(tscene.SceneBuilder)[0].build(device="cpu")
        assert port.rect_in_bvh and port.n_rect_bvh_nodes and port.n_bvh_nodes
    _assert_scene_equal(port, ref)


# --------------------------------------------------------------------------
# The plain K5 against the Pallas kernel (interpret) and the XLA traversal
# --------------------------------------------------------------------------

# (prim, fold_record, fold_full, precomp): every variant the kernels take.
VARIANTS = [("planar", False, False, False), ("planar", False, False, True),
            ("planar", True, False, False), ("planar", True, False, True),
            ("planar", True, True, False), ("planar", True, True, True),
            ("sphere", False, False, False), ("sphere", True, False, False),
            ("rect", False, False, False)]


def _shell_rays(rng, n, radius=9.0, spread=4.0):
    """Rays from a shell around the primitives toward points among them:
    hits well away from t_min, where float rounding cannot move a winner."""
    u = rng.normal(size=(3, n))
    o = u / np.linalg.norm(u, axis=0) * radius
    d = (rng.uniform(-spread, spread, (3, n)) - o) * rng.uniform(0.5, 2.0, n)
    return o.astype(np.float32), d.astype(np.float32)


def _rays(rng):
    o, d = _shell_rays(rng, B)
    d[0, :8] = 0.0  # axis-parallel rays: the safe inverse
    time = rng.uniform(0, 1, B).astype(np.float32)
    init_t = np.where(rng.random(B) < 0.2, rng.uniform(0.2, 1.0, B), BIG)
    init_i = rng.integers(0, 1000, B).astype(np.int32)
    return o, d, time, init_t.astype(np.float32), init_i


@pytest.mark.parametrize("prim,fold,full,pre", VARIANTS)
def test_plain_k5_matches_jax(prim, fold, full, pre):
    rng = np.random.default_rng(11)
    nodes, rows = _packed(prim, tbk, tbvh, rng)
    o, d, time, init_t, init_i = _rays(rng)
    kw = dict(leaf_size=LEAF, t_min=1e-3, prim=prim, fold_record=fold,
              fold_full=full, precomp=pre)
    want = jbk.bvh_closest_hit(
        jnp.asarray(nodes), jnp.asarray(rows), _jv3(o), _jv3(d),
        jnp.asarray(init_t), jnp.asarray(init_i), block=128, interpret=True,
        time=jnp.asarray(time), **kw)
    got = tbk.bvh_closest_hit(
        torch.from_numpy(nodes), torch.from_numpy(rows), _tv3(o), _tv3(d),
        torch.from_numpy(init_t), torch.from_numpy(init_i),
        time=torch.from_numpy(time), **kw)
    hit = np.asarray(want[2])
    assert hit.sum() > 20 and (~hit).sum() > 5
    np.testing.assert_array_equal(got[2].numpy(), hit)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-5)
    np.testing.assert_array_equal(got[0].numpy()[~hit], init_t[~hit])
    if fold:
        assert len(got) == len(want)
        g = np.concatenate([np.stack(got[3])] + [x.numpy()[None] for x in got[4:]])
        w = np.concatenate([np.stack([np.asarray(c) for c in want[3]])]
                           + [np.asarray(x)[None] for x in want[4:]])
        np.testing.assert_allclose(g[:, hit], w[:, hit], rtol=0, atol=1e-5)
        assert not g[:, ~hit].any()

    # The XLA per-ray traversal (another formula for the triangle test).
    xla = jbvh_ops.traverse_packed(
        jnp.asarray(nodes), jnp.asarray(rows), _jv3(o), _jv3(d),
        jnp.asarray(time), 1e-3, jnp.asarray(init_t), jnp.asarray(init_i),
        leaf_size=LEAF, prim=prim)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(xla[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(xla[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(xla[0]), rtol=2e-5)


@pytest.mark.parametrize("prim", ["planar", "sphere", "rect"])
def test_plain_k5_counts_its_work(prim):
    rng = np.random.default_rng(12)
    nodes, rows = _packed(prim, tbk, tbvh, rng)
    o, d, time, init_t, init_i = _rays(rng)
    out = tbvh_ops.traverse_packed(
        torch.from_numpy(nodes), torch.from_numpy(rows), _tv3(o), _tv3(d),
        torch.from_numpy(time), 1e-3, torch.from_numpy(init_t),
        torch.from_numpy(init_i), leaf_size=LEAF, prim=prim, counts=True)
    slabs, tests = out[-2].numpy(), out[-1].numpy()
    # Every ray tests the root; a leaf visit tests at most LEAF rows; a ray
    # that improved tested at least one primitive; no walk is longer than
    # the tree.
    assert (slabs >= 1).all() and (slabs <= nodes.shape[0]).all()
    assert (tests <= LEAF * slabs).all() and (tests[out[2].numpy()] >= 1).all()
    plain = tbk.bvh_closest_hit(
        torch.from_numpy(nodes), torch.from_numpy(rows), _tv3(o), _tv3(d),
        torch.from_numpy(init_t), torch.from_numpy(init_i), leaf_size=LEAF,
        prim=prim, time=torch.from_numpy(time))
    for a, b in zip(plain, out[:3]):
        assert torch.equal(a, b)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(13)
    nodes, rows = (torch.from_numpy(x) for x in _packed("rect", tbk, tbvh, rng))
    o, d, time, init_t, init_i = _rays(rng)
    args = (nodes, rows, _tv3(o), _tv3(d), torch.from_numpy(init_t),
            torch.from_numpy(init_i))
    with pytest.raises(TypeError, match="t_min"):
        tbk.bvh_closest_hit(*args, leaf_size=LEAF, prim="rect",
                            t_min=torch.tensor(1e-3))
    with pytest.raises(ValueError, match="fold_record"):
        tbk.bvh_closest_hit(*args, leaf_size=LEAF, prim="rect",
                            fold_record=True)
    with pytest.raises(ValueError, match="precomp"):
        tbk.bvh_closest_hit(*args, leaf_size=LEAF, prim="planar",
                            precomp=True)


# --------------------------------------------------------------------------
# intersect: the BVH and triangle parts
# --------------------------------------------------------------------------


SCENES = {
    "random": lambda cls: (jlib.random_scene() if cls is JBuilder else
                           tlib.random_scene(device="cpu")),
    "sheet_bvh": lambda cls: _built(_sheet(cls), cls, bvh=True),
    "sheet_sweep": lambda cls: _built(_sheet(cls), cls, bvh=False),
    "rects": lambda cls: _built(_rect_field(cls), cls),
}


def _built(bc, cls, **kw):
    b, cam = bc
    if cls is tscene.SceneBuilder:
        kw["device"] = "cpu"
    return b.build(**kw), cam


def _scene_rays(port, cam, rng):
    """Rays from the camera's position toward the scene, and rays from a
    shell around it."""
    o = np.tile(np.asarray(cam["lookfrom"], np.float32)[:, None], (1, B))
    d = (np.asarray(cam["lookat"], np.float32)[:, None] - o
         + rng.normal(size=(3, B)) * 1.5)
    o[:, B // 2:], d[:, B // 2:] = _shell_rays(rng, B - B // 2, spread=3.0)
    t = rng.uniform(0, 1, B)
    return o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_hit_and_record_match_jax(name):
    ref, cam = SCENES[name](JBuilder)
    port, _ = SCENES[name](tscene.SceneBuilder)
    o, d, t = _scene_rays(port, cam, np.random.default_rng(5))
    jt, jk, ji = jix.closest_hit(ref, _jv3(o), _jv3(d), jnp.asarray(t),
                                 jnp.zeros((B, 0)), 1e-3)
    tt, tk, ti = tix.closest_hit(port, _tv3(o), _tv3(d), torch.from_numpy(t),
                                 1e-3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    hit = np.asarray(jk) >= 0
    assert 20 < hit.sum() < B
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit], rtol=2e-5)

    jrec = jix.make_hit_record(ref, _jv3(o), _jv3(d), jnp.asarray(t), jt, jk, ji)
    trec = tix.make_hit_record(port, _tv3(o), _tv3(d), torch.from_numpy(t), tt,
                               tk, ti)
    for field in ("t", "u", "v", "tu", "tv"):
        np.testing.assert_allclose(getattr(trec, field).numpy()[hit],
                                   np.asarray(getattr(jrec, field))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    for field in ("p", "normal"):
        np.testing.assert_allclose(tv.to_numpy(getattr(trec, field))[hit],
                                   jv.to_numpy(getattr(jrec, field))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    assert (trec.mat.numpy()[hit] == np.asarray(jrec.mat)[hit]).all()
    assert (trec.front_face.numpy()[hit] == np.asarray(jrec.front_face)[hit]).all()


@pytest.mark.parametrize("name", ["sheet", "spheres"])
def test_folded_record_matches_jax(monkeypatch, name):
    """closest_hit(want_aux=True) and the record from the kernel-folded
    values, against the JAX package's folded path (Pallas in interpret
    mode): the planar full fold on the sheet, the sphere fold on a sphere
    tree."""
    make = {"sheet": lambda c: _sheet(c), "spheres": lambda c: _sphere_field(c)}[name]
    jb, cam = make(JBuilder)
    ref = jb.build(bvh=True, pallas_bvh=True, bvh_leaf_size=LEAF,
                   bvh_block=1024)
    tb, _ = make(tscene.SceneBuilder)
    port = tb.build(device="cpu", bvh=True, bvh_leaf_size=LEAF)
    o, d, t = _scene_rays(port, cam, np.random.default_rng(7))
    (jt, jk, ji), jaux = jix.closest_hit(ref, _jv3(o), _jv3(d), jnp.asarray(t),
                                         jnp.zeros((B, 0)), 1e-3, want_aux=True)
    (tt, tk, ti), taux = tix.closest_hit(port, _tv3(o), _tv3(d),
                                         torch.from_numpy(t), 1e-3,
                                         want_aux=True)
    assert taux[0] == jaux[0] == ("planar" if name == "sheet" else "sphere")
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jrec = jix.make_hit_record(ref, _jv3(o), _jv3(d), jnp.asarray(t), jt, jk,
                               ji, aux=jaux)
    trec = tix.make_hit_record(port, _tv3(o), _tv3(d), torch.from_numpy(t), tt,
                               tk, ti, aux=taux)
    hit = np.asarray(jk) >= 0
    assert hit.sum() > 20
    # The bar of the unfolded records (tests/test_torch_integrator.py).
    for field in ("t", "u", "v", "tu", "tv"):
        np.testing.assert_allclose(getattr(trec, field).numpy()[hit],
                                   np.asarray(getattr(jrec, field))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    for field in ("p", "normal"):
        np.testing.assert_allclose(tv.to_numpy(getattr(trec, field))[hit],
                                   jv.to_numpy(getattr(jrec, field))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=field)
    assert (trec.mat.numpy()[hit] == np.asarray(jrec.mat)[hit]).all()
