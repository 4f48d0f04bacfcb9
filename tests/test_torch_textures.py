"""Port vs JAX: Perlin noise and turbulence, the noise / image / barycentric
branches of ``texture_value``, the Perlin kernel K4's wrapper and its
zero-gradient Function, and the value-only noise rule of differentiable
renders (ROADMAP F4), with the port's deviation for instance transforms
(F9).

The plain Perlin version is held against the JAX package's ``perlin_noise``
and the Pallas kernel in interpret mode to atol 1e-6 (XLA contracts a*b+c
into FMA, the port does not: the two round apart by an ulp here and there).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import shade as jshade
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu.ops.pallas import perlin_kernel as jpk
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import shade as tshade
from another_raytracer_tpu_torch.ops import vec3 as tv
from another_raytracer_tpu_torch.ops.kernels import perlin_kernel as tpk
from jax_sphere_record import jax_reprojects_spheres  # noqa: F401

torch.set_num_threads(1)

B = 2048


def _jv3(a):
    return jv.V3(*(jnp.asarray(c) for c in a))


def _tv3(a):
    return tv.V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _texture_scene(builder_cls):
    """Two noise textures (two table sets), an image texture of generated
    texels, a barycentric and a checker texture, and a solid colour."""
    b = builder_cls(background=(0.5, 0.6, 0.8), seed=7)
    texels = np.random.default_rng(3).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    for tex in (b.noise_texture(4.0), b.noise_texture(0.1),
                b.image_texture(texels),
                b.barycentric_texture((1, 0, 0), (0, 1, 0), (0, 0, 1)),
                b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))):
        b.sphere((0, 0, -2), 0.5, b.lambertian(texture=tex))
    b.sphere((0, 0, -2), 0.5, b.lambertian(color=(0.3, 0.2, 0.1)))
    return b


@functools.lru_cache(maxsize=None)
def _scenes():
    ref = _texture_scene(JBuilder).build()
    port = _texture_scene(tscene.SceneBuilder).build(device="cpu")
    return ref, port


def _points(seed=0):
    """Points of small and large magnitude and both signs (the final scene
    evaluates noise at scale 0.1 at |p| ~ 500)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-2.0, 2.0, (3, B))
    p[:, B // 2:] = rng.uniform(-60.0, 60.0, (3, B - B // 2))
    p[:, :16] = np.floor(p[:, :16])  # lattice points
    return p.astype(np.float32)


@pytest.mark.parametrize("table", [0, 1, "mixed"])
def test_perlin_noise_matches_jax(table):
    ref, port = _scenes()
    p = _points(1)
    ids = (np.random.default_rng(2).integers(0, 2, B) if table == "mixed"
           else np.full(B, table)).astype(np.int32)
    want = np.asarray(jshade.perlin_noise(ref, jnp.asarray(ids), _jv3(p)))
    got = tshade.perlin_noise(port, torch.from_numpy(ids), _tv3(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.3
    # The wrapper of K4 runs the plain version on CPU tensors.
    wrapped = tpk.perlin_noise(port, torch.from_numpy(ids), _tv3(p))
    assert torch.equal(wrapped, torch.from_numpy(got))
    if table == 0:
        # The Pallas kernel (one table set) in interpret mode.
        one = JBuilder(seed=7)
        one.noise_texture(4.0)
        one.sphere((0, 0, 0), 1.0, 0)
        jscene = one.build()
        pal = np.asarray(jpk.perlin_noise_tpu(jscene, _jv3(p), interpret=True))
        np.testing.assert_allclose(got, pal, rtol=0, atol=1e-6)


def test_perlin_turb_matches_jax():
    ref, port = _scenes()
    p = _points(3)[:, :256]
    want = np.asarray(jshade.perlin_turb(ref, jnp.zeros(256, jnp.int32),
                                         _jv3(p)))
    got = tshade.perlin_turb(port, torch.zeros(256, dtype=torch.int64),
                             _tv3(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_nograd_function_is_value_with_zero_gradient():
    _, port = _scenes()
    p = _tv3(_points(4)).map(lambda c: c.clone().requires_grad_(True))
    ids = torch.zeros(B, dtype=torch.int64)
    val = tpk.perlin_noise_nograd(port, ids, p)
    assert torch.equal(val.detach(), tshade.perlin_noise(port, ids, p).detach())
    grads = torch.autograd.grad(val.sum(), list(p))
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)
    # The plain version's gradient is real.
    grads = torch.autograd.grad(tshade.perlin_noise(port, ids, p).sum(), list(p))
    assert float(grads[0].abs().max()) > 0


@pytest.mark.parametrize("fast_texel", [False, True])
def test_texture_value_matches_jax(fast_texel):
    ref, port = _scenes()
    rng = np.random.default_rng(5)
    tex = rng.integers(0, port.tex_kind.shape[0], B).astype(np.int32)
    u, v = rng.uniform(0, 1, (2, B)).astype(np.float32)
    tu, tvv = rng.uniform(-0.2, 1.2, (2, B)).astype(np.float32)
    p = _points(6)
    want = jshade.texture_value(ref, jnp.asarray(tex), jnp.asarray(u),
                                jnp.asarray(v), jnp.asarray(tu),
                                jnp.asarray(tvv), _jv3(p))
    got = tshade.texture_value(port, torch.from_numpy(tex).long(),
                               torch.from_numpy(u), torch.from_numpy(v),
                               torch.from_numpy(tu), torch.from_numpy(tvv),
                               _tv3(p), fast_texel=fast_texel)
    np.testing.assert_allclose(tv.to_numpy(got), jv.to_numpy(want), rtol=0,
                               atol=1e-6)
    kinds = port.tex_kind.numpy()[tex]
    assert set(kinds) == {0, 1, 2, 3, 4}


# --------------------------------------------------------------------------
# The value-only noise rule (ROADMAP F4)
# --------------------------------------------------------------------------

W, H, DEPTH = 16, 12, 3
TRAINABLE = {"shading": ("background", "tex_ca"), "tex_scale": ("tex_scale",),
             "mat_fuzz": ("mat_fuzz",)}
# The rule's verdict: may the render take the kernel's zero-gradient noise?
VALUE_ONLY = {("noise", "shading"): True, ("noise", "tex_scale"): False,
              ("noise", "mat_fuzz"): True, ("noise_metal", "shading"): True,
              ("noise_metal", "tex_scale"): False,
              ("noise_metal", "mat_fuzz"): False}
SEEDS = {"noise": 1, "noise_metal": 0}


def _noise_builder(cls, metal):
    # scene 3's textures on a rect ground: the hit points on scene 3's
    # radius-1000 ground sphere cancel ~6 digits, which the two packages
    # round apart (XLA contracts FMA), and noise at scale 4 shows it.
    b = cls(background=(0.7, 0.8, 1.0), seed=11)
    pertext = b.noise_texture(4.0)
    b.xz_rect(-100, 100, -100, 100, 0, b.lambertian(texture=pertext))
    b.sphere((0, 2, 0), 2, b.lambertian(texture=pertext))
    if metal:
        b.sphere((3, 1.5, 2), 1.5, b.metal((0.8, 0.8, 0.8), fuzz=0.3))
    return b


@functools.lru_cache(maxsize=None)
def _noise_case(name, train):
    """JAX scene, camera, target and jax.value_and_grad of render_loss."""
    metal = name == "noise_metal"
    ref = _noise_builder(JBuilder, metal).build()
    params = dict(lookfrom=(5, 3, 3), lookat=(0, 1, 0), vfov=60.0)
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    target = np.random.default_rng(2).uniform(0, 0.5, (W * H, 3)).astype(np.float32)
    kw = dict(width=W, height=H, spp=1, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)
    leaves = {k: getattr(ref, k) for k in TRAINABLE[train]}
    seed = SEEDS[name]
    acc, segs = jrender.render_radiance(ref, ref_cam, jnp.uint32(seed),
                                        differentiable=True,
                                        trainable=tuple(sorted(leaves)), **kw)
    loss, grads = jax.value_and_grad(jdiff.render_loss)(
        leaves, ref, ref_cam, jnp.asarray(target), jnp.uint32(seed), **kw)
    return (params, target, kw, seed, jv.to_numpy(acc), int(segs), float(loss),
            {k: np.asarray(g) for k, g in grads.items()})


@pytest.mark.parametrize("route", ["rule", "lockstep"])
@pytest.mark.parametrize("train", list(TRAINABLE))
@pytest.mark.parametrize("name", ["noise", "noise_metal"])
def test_noise_value_only_rule_matches_jax_gradients(name, train, route,
                                                     monkeypatch,
                                                     jax_reprojects_spheres):
    """Gradients of render_loss against jax.value_and_grad (which on the CPU
    always differentiates through the noise), through the route the rule
    picks and through the lockstep route with the noise differentiated."""
    params, target, kw, seed, acc_w, seg_w, loss_w, grads_w = _noise_case(
        name, train)
    port = _noise_builder(tscene.SceneBuilder, name == "noise_metal").build(
        device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    trainable = tuple(sorted(TRAINABLE[train]))
    assert trender.noise_value_only(port, trainable) == VALUE_ONLY[name, train]
    if route == "lockstep":
        monkeypatch.setattr(trender, "noise_value_only", lambda *a: False)
    calls = []
    real = tpk.perlin_noise_nograd
    monkeypatch.setattr(tpk, "perlin_noise_nograd",
                        lambda *a: calls.append(1) or real(*a))

    # Same paths first: equal segments, and per-pixel radiance within 1e-3.
    # Noise at scale 4 moves by ~10x its point's rounding (XLA's sin / cos
    # and FMA round apart from the port's), so the radiance agrees to
    # ~1e-4 where the paths agree; a path that flips moves it by ~1e-1.
    with torch.no_grad():
        acc_g, seg_g = trender.render_radiance(port, cam, seed,
                                               differentiable=True,
                                               trainable=trainable, **kw)
    assert int(seg_g) == seg_w
    np.testing.assert_allclose(tv.to_numpy(acc_g), acc_w, rtol=0, atol=1e-3)
    assert bool(calls) == (route == "rule" and VALUE_ONLY[name, train])

    leaves = {k: getattr(port, k) for k in trainable}
    loss_g, grads_g = diff.render_value_and_grad(
        leaves, port, cam, torch.from_numpy(target), seed, **kw)
    np.testing.assert_allclose(float(loss_g), loss_w, rtol=1e-5)
    for k, want in grads_w.items():
        got = grads_g[k].numpy()
        scale = max(np.abs(want).max(), 1e-9)
        np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=k)
    if train != "mat_fuzz" or name == "noise_metal":
        assert max(np.abs(g).max() for g in grads_w.values()) > 0


def _instanced_noise_builder(cls):
    # An instanced noise sphere (rotated and moved by its transform) on a
    # noise rect ground: xf_trans moves the sphere's hit points, where the
    # noise is evaluated.
    b = cls(background=(0.7, 0.8, 1.0), seed=11)
    pertext = b.noise_texture(4.0)
    b.xz_rect(-100, 100, -100, 100, 0, b.lambertian(texture=pertext))
    xf = b.transform(rotate_y_deg=30.0, translate=(0.5, 0.0, -0.5))
    b.sphere((0, 2, 0), 2, b.lambertian(texture=pertext), xform=xf)
    return b


@functools.lru_cache(maxsize=None)
def _instanced_noise_case():
    """Camera, target, render settings, seed, and JAX's loss and xf_trans
    gradient (jax.value_and_grad of render_loss)."""
    ref = _instanced_noise_builder(JBuilder).build()
    params = dict(lookfrom=(5, 3, 3), lookat=(0, 1, 0), vfov=60.0)
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    target = np.random.default_rng(2).uniform(0, 0.5, (W * H, 3)).astype(np.float32)
    kw = dict(width=W, height=H, spp=1, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)
    seed = 1
    loss, grads = jax.value_and_grad(jdiff.render_loss)(
        {"xf_trans": ref.xf_trans}, ref, ref_cam, jnp.asarray(target),
        jnp.uint32(seed), **kw)
    return params, target, kw, seed, float(loss), np.asarray(grads["xf_trans"])


@pytest.mark.parametrize("route", ["rule", "value_only"])
def test_noise_rule_trains_instance_transforms_like_jax(
        route, monkeypatch, jax_reprojects_spheres):
    """The port lists ``xf_`` among the leaves that reach the noise point
    (a deliberate deviation from JAX's list, ops/render.py): trained
    ``xf_trans`` gradients through the rule's route match
    jax.value_and_grad, which differentiates through the noise; forced onto
    the value-only noise they would not."""
    params, target, kw, seed, loss_w, want = _instanced_noise_case()
    assert np.abs(want[1:]).max() > 0

    port = _instanced_noise_builder(tscene.SceneBuilder).build(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    assert not trender.noise_value_only(port, ("xf_trans",))
    if route == "value_only":
        monkeypatch.setattr(trender, "noise_value_only", lambda *a: True)
    loss_g, grads_g = diff.render_value_and_grad(
        {"xf_trans": port.xf_trans}, port, cam, torch.from_numpy(target), seed,
        **kw)
    np.testing.assert_allclose(float(loss_g), loss_w, rtol=1e-5)
    got = grads_g["xf_trans"].numpy()
    scale = np.abs(want).max()
    close = np.allclose(got, want, atol=2e-4 * scale, rtol=2e-4)
    assert close == (route == "rule"), (got, want)
