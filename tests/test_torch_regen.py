"""The port's regenerating forward wavefront (``integrator.trace_regenerative``)
and the forward renders of the BVH and texture scenes.

* Bit-equal to the port's own lockstep loop at samples_per_pass 1, with the
  staged compaction forced to narrow stages (as tests/test_regen.py:51-73
  asserts for JAX): every lane accumulates its samples in the same
  (sample, bounce) order with the same draws.
* Against the JAX package's ``trace_regenerative`` and ``render.render`` of
  scenes 1, 3, 4 and 5, with the bar of tests/test_mega.py:37-45.
* ``morton_order`` equal to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.config import RenderConfig as JConfig
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import integrator as jint
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jv
from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import integrator as tint
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tv
from jax_sphere_record import jax_reprojects_spheres  # noqa: F401
from test_torch_bvh import _sheet

torch.set_num_threads(1)

W, H, DEPTH = 48, 36, 5


def _port(name):
    """Port scene and camera params of one of the scenes below."""
    if name == "sheet":
        b, cam = _sheet(tscene.SceneBuilder)
        return b.build(device="cpu", bvh=True), cam
    return getattr(tlib, name)(device="cpu")


def _ref(name):
    if name == "sheet":
        b, cam = _sheet(JBuilder)
        return b.build(bvh=True), cam
    return getattr(jlib, name)()


def _regen(scene, cam, spp, spass, seed=0, width=W, height=H):
    n = width * height
    pix = torch.arange(n, dtype=torch.int64).repeat(spass)
    samp = torch.arange(spass, dtype=torch.int64).repeat_interleave(n)
    acc, segs = tint.trace_regenerative(
        scene, cam, pix, samp, seed, width=width, height=height,
        sample_stride=spass, sample_end=spp, spp_cap=spp, max_depth=DEPTH,
        t_min=1e-3)
    return tv.to_numpy(acc.map(lambda c: c.reshape(spass, n).sum(0))), int(segs)


def _lockstep(scene, cam, spp, seed=0):
    with torch.no_grad():
        acc, segs = trender.radiance_batch(
            scene, cam, torch.arange(W * H), seed, width=W, height=H,
            sample_start=0, n_samples=spp, spp_cap=spp, samples_per_pass=1,
            max_depth=DEPTH, t_min=1e-3, differentiable=True)
    return tv.to_numpy(acc), int(segs)


@pytest.mark.parametrize("name", ["random_scene", "two_perlin_spheres",
                                  "sheet", "cornell_box"])
def test_regen_bit_equal_to_lockstep(name, monkeypatch):
    """Staged compaction forced to narrow widths (1728 -> 256 -> 128 lanes),
    bit-equal to the single-stage wavefront and to the lockstep loop."""
    monkeypatch.setattr(tint, "REGEN_COMPACT_MIN_B", 64)
    assert tint._stage_widths(W * H) == [W * H, 256, 128]
    scene, params = _port(name)
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    a, sa = _regen(scene, cam, spp=6, spass=1)
    b, sb = _lockstep(scene, cam, spp=6)
    np.testing.assert_array_equal(a, b)
    assert sa == sb
    # spass 2 with a ragged sample end, with and without the compaction.
    c, sc = _regen(scene, cam, spp=5, spass=2)
    monkeypatch.setattr(tint, "REGEN_COMPACT_MIN_B", 1 << 30)
    d, sd = _regen(scene, cam, spp=5, spass=2)
    np.testing.assert_array_equal(c, d)
    assert sc == sd


@pytest.mark.parametrize("name", ["random_scene", "sheet"])
def test_regen_matches_jax(name):
    scene, params = _port(name)
    ref, _ = _ref(name)
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    n = W * H
    pix = np.tile(np.arange(n, dtype=np.uint32), 2)
    samp = np.repeat(np.arange(2, dtype=np.uint32), n)
    kw = dict(width=W, height=H, sample_stride=2, sample_end=4, spp_cap=4,
              max_depth=DEPTH, t_min=1e-3)
    want, wsegs = jint.trace_regenerative(ref, ref_cam, jnp.asarray(pix),
                                          jnp.asarray(samp), jnp.uint32(3), **kw)
    got, gsegs = tint.trace_regenerative(
        scene, cam, torch.from_numpy(pix.astype(np.int64)),
        torch.from_numpy(samp.astype(np.int64)), 3, **kw)
    assert abs(int(gsegs) - int(wsegs)) <= max(4, 0.01 * int(wsegs))
    diff = np.abs(tv.to_numpy(got) - jv.to_numpy(want))
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name,spp", [("random_scene", 4),
                                      ("two_perlin_spheres", 4),
                                      ("earth", 2), ("simple_light", 4)])
def test_render_matches_jax(name, spp, jax_reprojects_spheres):
    w, h = 24, 18
    cfg = dict(width=w, height=h, samples_per_pixel=spp, max_depth=10, seed=2)
    scene, params = _port(name)
    ref, _ = _ref(name)
    cam = tcam.make_camera(aspect_ratio=w / h, device="cpu", **params)
    ref_cam = jcam.make_camera(aspect_ratio=w / h, **params)
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=1, max_depth=10,
              t_min=1e-3)
    want, wsegs = jrender.render_radiance(ref, ref_cam, jnp.uint32(2), **kw)
    got, gsegs = trender.render_radiance(scene, cam, 2, **kw)
    assert abs(int(gsegs) - int(wsegs)) <= max(4, 0.01 * int(wsegs))
    diff = np.abs(tv.to_numpy(got) - jv.to_numpy(want))
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5
    want_img, _ = jrender.render(ref, ref_cam, JConfig(**cfg))
    got_img, stats = trender.render(scene, cam, RenderConfig(**cfg))
    assert got_img.shape == (h, w, 3) and stats["segments"] == int(gsegs)
    close = np.abs(got_img.astype(int) - np.asarray(want_img).astype(int)) <= 2
    assert close.mean() >= 0.98


@pytest.mark.parametrize("size", [(24, 18), (720, 540), (7, 5)])
def test_morton_order_matches_jax(size):
    order, inv = trender.morton_order(*size)
    jorder, jinv = jrender.morton_order(*size)
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(inv, jinv)
    assert order.dtype == np.uint32
