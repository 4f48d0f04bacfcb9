"""Port vs JAX: the modules of the lockstep differentiable path —
``vec3`` / ``vecmath``, ``intersect`` (sweep), ``shade`` (main class) and
``integrator.trace`` — on inputs made from a numpy seed.

The port takes sqrt, sin and cos correctly rounded (through float64); XLA's
sqrt is correctly rounded too, its sin/cos (glibc's) are an ulp off on ~1%
of inputs and its cbrt on ~12%, so single results agree to a few ulps
(rtol 1e-6) and whole paths to the forward bar of tests/test_mega.py:37-45.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import integrator as jint
from another_raytracer_tpu.ops import intersect as jix
from another_raytracer_tpu.ops import shade as jshade
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu.ops import vecmath as jvm
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import integrator as tint
from another_raytracer_tpu_torch.ops import intersect as tix
from another_raytracer_tpu_torch.ops import shade as tshade
from another_raytracer_tpu_torch.ops import vec3 as tv
from another_raytracer_tpu_torch.ops import vecmath as tvm

torch.set_num_threads(1)

W, H, DEPTH = 16, 12, 5
B = 512


def _mixed_scene():
    # Spheres (one moving, one instanced), rects, a rotated box; lambertian,
    # metal, dielectric, light; solid and checker textures.
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    xf = b.transform(rotate_y_deg=30, translate=(0.6, 0.0, -2.0))
    b.box((-0.2, 0.0, -0.2), (0.2, 0.6, 0.2), b.metal((0.7, 0.7, 0.7), 0.1),
          xform=xf)
    b.sphere((0.0, 0.2, 0.0), 0.15, b.lambertian(color=(0.3, 0.9, 0.3)),
             xform=xf)
    b.xy_rect(-3, 3, 0, 2, -3, b.diffuse_light(color=(4, 4, 4)))
    return b.build(), dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1),
                           vfov=60.0, aperture=0.1, focus_dist=2.5,
                           time0=0.0, time1=1.0)


SCENES = {"cornell": jlib.cornell_box, "checker": jlib.two_spheres,
          "mixed": _mixed_scene}


def _both(name):
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    return ((ref, ref_cam), (tscene.scene_from_reference(ref),
                             tcam.camera_from_reference(ref_cam)))


def _jv(a):
    return jv.V3(*(jnp.asarray(c) for c in a))


def _tv(a):
    return tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _rays(name, seed=0):
    """Camera rays mixed with random rays from random points in the scene."""
    (ref, ref_cam), (port, cam) = _both(name)
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, W * H, B)
    samp = rng.integers(0, 4, B)
    o, d, t = tcam.generate_rays(cam, torch.from_numpy(pix),
                                 torch.from_numpy(samp), W, H, 1,
                                 needs_time=port.has_motion)
    o, d, t = (tv.to_numpy(o), tv.to_numpy(d), t.numpy())
    scale = 555.0 if name == "cornell" else 2.0
    half = B // 2
    o[half:] = rng.uniform(0.05, 0.95, (B - half, 3)) * scale
    if name != "cornell":
        o[half:] -= scale / 2
    d[half:] = rng.normal(size=(B - half, 3))
    o, d, t = o.astype(np.float32), d.astype(np.float32), t.astype(np.float32)
    return (ref, port), (o.T, d.T, t), (pix, samp)


# --------------------------------------------------------------------------
# vec3 / vecmath
# --------------------------------------------------------------------------


def test_vec3_matches_jax():
    rng = np.random.default_rng(1)
    a, n = (rng.normal(size=(3, 64)).astype(np.float32) for _ in range(2))
    n = n / np.linalg.norm(n, axis=0)
    a[:, :4] = 0.0
    a[:, 4] = 1e-9  # near zero
    u = rng.random((3, 64)).astype(np.float32)
    ratio = rng.uniform(0.5, 1.6, 64).astype(np.float32)
    ja, jn, ta, tn = _jv(a), _jv(n), _tv(a), _tv(n)
    ua = tv.unit(ta)
    _close(tv.length(ta), jv.length(ja))
    _close(tv.length_squared(ta), jv.length_squared(ja))
    _close(np.stack(tv.unit(ta)), np.stack(jv.unit(ja)))
    assert (tv.near_zero(ta).numpy() == np.asarray(jv.near_zero(ja))).all()
    assert tv.near_zero(ta)[:5].all()
    _close(np.stack(tv.reflect(ta, tn)), np.stack(jv.reflect(ja, jn)))
    _close(np.stack(tv.refract(ua, tn, torch.from_numpy(ratio))),
           np.stack(jv.refract(jv.unit(ja), jn, jnp.asarray(ratio))))
    _close(np.stack(tv.cross(ta, tn)), np.stack(jv.cross(ja, jn)))
    rows = (ta, tn, tv.cross(ta, tn))
    jrows = (ja, jn, jv.cross(ja, jn))
    _close(np.stack(tv.rotate(rows, tn)), np.stack(jv.rotate(jrows, jn)))
    uu = [torch.from_numpy(x) for x in u]
    ju = [jnp.asarray(x) for x in u]
    _close(np.stack(tv.unit_vector_from_uniforms(*uu[:2])),
           np.stack(jv.unit_vector_from_uniforms(*ju[:2])))
    _close(np.stack(tv.in_unit_sphere_from_uniforms(*uu)),
           np.stack(jv.in_unit_sphere_from_uniforms(*ju)))
    _close(np.stack(tv.in_hemisphere_from_uniforms(*uu, tn)),
           np.stack(jv.in_hemisphere_from_uniforms(*ju, jn)))
    _close(np.stack(tv.in_unit_disk_from_uniforms(*uu[:2])),
           np.stack(jv.in_unit_disk_from_uniforms(*ju[:2])))


def test_vecmath_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    a[:3] = 1e-9
    u = rng.random((3, 64)).astype(np.float32)
    ratio = rng.uniform(0.5, 1.6, 64).astype(np.float32)
    ta, tn = torch.from_numpy(a), torch.from_numpy(n)
    ja, jn = jnp.asarray(a), jnp.asarray(n)
    _close(tvm.length_squared(ta), jvm.length_squared(ja))
    _close(tvm.length(ta), jvm.length(ja))
    _close(tvm.unit(ta), jvm.unit(ja))
    assert (tvm.near_zero(ta).numpy() == np.asarray(jvm.near_zero(ja))).all()
    assert tvm.near_zero(ta)[:3].all()
    _close(tvm.reflect(ta, tn), jvm.reflect(ja, jn))
    _close(tvm.refract(tvm.unit(ta), tn, torch.from_numpy(ratio)),
           jvm.refract(jvm.unit(ja), jn, jnp.asarray(ratio)))
    _close(tvm.dot(ta, tn), jvm.dot(ja, jn))
    _close(tvm.cross(ta, tn), jvm.cross(ja, jn))
    uu = [torch.from_numpy(x) for x in u]
    ju = [jnp.asarray(x) for x in u]
    _close(tvm.unit_vector_from_uniforms(*uu[:2]),
           jvm.unit_vector_from_uniforms(*ju[:2]))
    _close(tvm.in_unit_sphere_from_uniforms(*uu),
           jvm.in_unit_sphere_from_uniforms(*ju))
    _close(tvm.in_unit_disk_from_uniforms(*uu[:2]),
           jvm.in_unit_disk_from_uniforms(*ju[:2]))
    _close(tvm.in_hemisphere(ta, tn), jvm.in_hemisphere(ja, jn))


# --------------------------------------------------------------------------
# intersect and shade
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_hit_and_record_match_jax(name):
    (ref, port), (o, d, t), _ = _rays(name)
    jt, jk, ji = jix.closest_hit(ref, _jv(o), _jv(d), jnp.asarray(t),
                                 jnp.zeros((B, 0)), 1e-3)
    tt, tk, ti = tix.closest_hit(port, _tv(o), _tv(d), torch.from_numpy(t), 1e-3)
    same = (tk.numpy() == np.asarray(jk)) & (ti.numpy() == np.asarray(ji))
    assert same.mean() >= 0.99, same.mean()
    assert (tk >= 0).any() and (tk < 0).any() or name == "cornell"
    _close(tt.numpy()[same], np.asarray(jt)[same], rtol=1e-5)

    jrec = jix.make_hit_record(ref, _jv(o), _jv(d), jnp.asarray(t), jt, jk, ji)
    trec = tix.make_hit_record(port, _tv(o), _tv(d), torch.from_numpy(t), tt,
                               tk, ti)
    hit = same & (np.asarray(jk) >= 0)
    for field in ("t", "u", "v", "tu", "tv"):
        _close(getattr(trec, field).numpy()[hit],
               np.asarray(getattr(jrec, field))[hit], rtol=1e-4, atol=1e-4)
    for field in ("p", "normal"):
        _close(tv.to_numpy(getattr(trec, field))[hit],
               jv.to_numpy(getattr(jrec, field))[hit], rtol=1e-4, atol=1e-3)
    assert (trec.front_face.numpy()[hit] == np.asarray(jrec.front_face)[hit]).all()
    assert (trec.mat.numpy()[hit] == np.asarray(jrec.mat)[hit]).all()

    # emit_and_scatter on the same records (the JAX record, carried over).
    prec = tix.HitRecord(*(_tv(np.asarray(jv.to_numpy(f)).T) if isinstance(f, jv.V3)
                           else torch.from_numpy(np.array(f)) for f in jrec))
    prec = prec._replace(mat=prec.mat.long())
    pix, samp = (np.arange(B), np.full(B, 3))
    jout = jshade.emit_and_scatter(ref, jrec, _jv(d), jnp.asarray(pix, jnp.uint32),
                                   jnp.asarray(samp, jnp.uint32), jnp.uint32(2),
                                   jnp.uint32(7))
    tout = tshade.emit_and_scatter(port, prec, _tv(d), torch.from_numpy(pix),
                                   torch.from_numpy(samp), 2, 7)
    hit = np.asarray(jk) >= 0
    for jx, tx in zip(jout[:3], tout[:3]):
        _close(tv.to_numpy(tx)[hit], jv.to_numpy(jx)[hit], rtol=1e-5, atol=1e-5)
    assert (tout[3].numpy()[hit] == np.asarray(jout[3])[hit]).all()
    d_t, a_t, ok_t = tshade.scatter(port, prec, _tv(d), torch.from_numpy(pix),
                                    torch.from_numpy(samp), 2, 7)
    assert all(torch.equal(x, y) for x, y in zip(d_t, tout[1]))
    assert torch.equal(ok_t, tout[3])
    _close(tv.to_numpy(tshade.emitted(port, prec))[hit],
           jv.to_numpy(jshade.emitted(ref, jrec))[hit])


# --------------------------------------------------------------------------
# The lockstep integrator
# --------------------------------------------------------------------------


def _primary(name, spp_index=1, seed=4):
    (ref, ref_cam), (port, cam) = _both(name)
    pix = np.arange(W * H)
    samp = np.full(W * H, spp_index)
    jo, jd, jt = jcam.generate_rays(ref_cam, jnp.asarray(pix, jnp.uint32),
                                    jnp.asarray(samp, jnp.uint32), W, H,
                                    jnp.uint32(seed), needs_time=ref.has_motion)
    to, td, tt = tcam.generate_rays(cam, torch.from_numpy(pix),
                                    torch.from_numpy(samp), W, H, seed,
                                    needs_time=port.has_motion)
    return (ref, (jo, jd, jt)), (port, (to, td, tt)), (pix, samp, seed)


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_matches_jax(name):
    (ref, jr), (port, tr), (pix, samp, seed) = _primary(name)
    want, wsegs = jint.trace(ref, *jr, jnp.asarray(pix, jnp.uint32),
                             jnp.asarray(samp, jnp.uint32), jnp.uint32(seed),
                             DEPTH, 1e-3, differentiable=True)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            got, gsegs = tint.trace(port, *tr, torch.from_numpy(pix),
                                    torch.from_numpy(samp), seed, DEPTH, 1e-3)
        assert abs(int(gsegs) - int(wsegs)) <= max(4, 0.01 * int(wsegs))
        diff = np.abs(tv.to_numpy(got) - jv.to_numpy(want))
        assert (diff > 2e-2).mean() <= 0.02 and np.median(diff) < 1e-5


@pytest.mark.parametrize("name,leaf", [("cornell", "rect_k"),
                                       ("checker", "sph_c0"),
                                       ("mixed", "sph_c0"), ("mixed", "sph_r"),
                                       ("mixed", "xf_trans")])
def test_geometry_gradient_matches_jax(name, leaf):
    """Geometry gradients against jax.grad.  Through the winner recompute
    (hit point, normal and t of every lane, misses and other kinds
    included) they are real; through a whole trace they are zero here —
    solid and checker textures make the radiance piecewise constant in the
    hit points.  No masked lane may turn either into NaN."""
    (ref, port), (o, d, t), _ = _rays(name)
    w = np.random.default_rng(5).uniform(0.2, 1.0, (7, B)).astype(np.float32)
    jt, jk, ji = jix.closest_hit(ref, _jv(o), _jv(d), jnp.asarray(t),
                                 jnp.zeros((B, 0)), 1e-3)

    def jrecord_loss(x):
        rec = jix.make_hit_record(ref.replace(**{leaf: x}), _jv(o), _jv(d),
                                  jnp.asarray(t), jt, jk, ji)
        parts = (*rec.p, *rec.normal, rec.t)
        return sum(jnp.sum(c * jnp.asarray(wc)) for c, wc in zip(parts, w))

    want = np.asarray(jax.grad(jrecord_loss)(getattr(ref, leaf)))
    with torch.no_grad():
        tt, tk, ti = tix.closest_hit(port, _tv(o), _tv(d), torch.from_numpy(t),
                                     1e-3)
    x = getattr(port, leaf).clone().requires_grad_(True)
    rec = tix.make_hit_record(port.replace(**{leaf: x}), _tv(o), _tv(d),
                              torch.from_numpy(t), tt, tk, ti)
    parts = (*rec.p, *rec.normal, rec.t)
    loss = sum((c * torch.from_numpy(wc)).sum() for c, wc in zip(parts, w))
    (got,) = torch.autograd.grad(loss, [x])
    assert torch.isfinite(got).all()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())

    if name == "mixed":
        return  # the whole-trace check below runs on the two named cases
    # Through a whole trace.
    (ref, jr), (port, tr), (pix, samp, seed) = _primary(name)
    wp = w[:3, :W * H]

    def jloss(x):
        acc, _ = jint.trace(ref.replace(**{leaf: x}), *jr,
                            jnp.asarray(pix, jnp.uint32),
                            jnp.asarray(samp, jnp.uint32), jnp.uint32(seed),
                            DEPTH, 1e-3, differentiable=True)
        return sum(jnp.sum(c * jnp.asarray(wc)) for c, wc in zip(acc, wp))

    want = np.asarray(jax.grad(jloss)(getattr(ref, leaf)))
    x = getattr(port, leaf).clone().requires_grad_(True)
    tex = port.tex_ca.clone().requires_grad_(True)
    acc, _ = tint.trace(port.replace(**{leaf: x, "tex_ca": tex}), *tr,
                        torch.from_numpy(pix), torch.from_numpy(samp), seed,
                        DEPTH, 1e-3)
    loss = sum((c * torch.from_numpy(wc)).sum() for c, wc in zip(acc, wp))
    got, g_tex = torch.autograd.grad(loss, [x, tex], allow_unused=True)
    got = torch.zeros_like(x) if got is None else got
    assert torch.isfinite(got).all() and torch.isfinite(g_tex).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(g_tex.abs().max()) > 0


def test_trace_refuses_unported_kinds():
    b = JBuilder(seed=1)
    b.triangle((0, 0, -2), (1, 0, -2), (0, 1, -2), b.lambertian(color=(1, 0, 0)))
    tri = tscene.scene_from_reference(b.build())
    b = JBuilder(seed=1)
    b.constant_medium_sphere((0, 0, -2), 1.0, 0.5, color=(1, 1, 1))
    med = tscene.scene_from_reference(b.build())
    tint.check_supported(tri)  # triangles are traced since the BVH slice
    with pytest.raises(NotImplementedError, match="M15"):
        tint.check_supported(med)
