"""Port vs JAX: the forward megakernel's row pack and its plain PyTorch
version, held against the Pallas kernel in interpret mode with the bar of
tests/test_mega.py:37-45 (segment drift <= max(4, 1%), <= 2% of lane values
off by more than 2e-2, median difference < 1e-5: ulp-level differences in
sin/cos/sqrt between XLA and PyTorch can flip a path at an edge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.ops.pallas import mega_kernel as jmk
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk

torch.set_num_threads(1)

W, H, SPP, DEPTH = 24, 18, 4, 5
KW = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
          max_depth=DEPTH, t_min=1e-3)


def _metal_scene():
    # Lens + motion + metal + dielectric + checker (tests/test_mega.py:53-66).
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(), cam


SCENES = {
    "cornell_box": jlib.cornell_box,
    "two_spheres": jlib.two_spheres,
    "lens_motion_metal_dielectric_checker": _metal_scene,
}


def _both(name):
    """(JAX scene, JAX camera), (port scene, port camera) for one scene."""
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    port = tscene.scene_from_reference(ref)
    return (ref, ref_cam), (port, tcam.camera_from_reference(ref_cam))


def _lanes():
    return torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64)


def _radiance_batch(scene, cam, pixel_ids, **kw):
    return trender.radiance_batch(scene, cam, pixel_ids, 3, **kw)


@pytest.mark.parametrize("name", list(SCENES))
def test_pack_rows_matches_reference(name):
    (ref, ref_cam), (port, cam) = _both(name)
    np.testing.assert_allclose(tmk.pack_rows(port).numpy(),
                               np.asarray(jmk.pack_rows(ref)), rtol=1e-6,
                               atol=1e-6)
    assert tmk.supports(port, cam) and jmk.supports(ref, ref_cam)


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_kernel_matches_reference(name):
    (ref, ref_cam), (port, cam) = _both(name)
    want, want_segs = jmk.trace_regenerative_mega(
        ref, ref_cam, jnp.arange(W * H, dtype=jnp.uint32),
        jnp.zeros(W * H, jnp.uint32), jnp.uint32(3), interpret=True, **KW)
    got, got_segs = tmk.trace_regenerative_mega(port, cam, *_lanes(), 3, **KW)
    want, got = jvec3.to_numpy(want), tvec3.to_numpy(got)
    assert abs(int(got_segs) - int(want_segs)) <= max(4, 0.01 * int(want_segs))
    diff = np.abs(got - want)
    assert (diff > 2e-2).mean() <= 0.02, f"max {diff.max():.2e}"
    assert np.median(diff) < 1e-5


def test_pad_and_masked_lanes_contribute_nothing():
    port, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    pix, samp = _lanes()
    base, base_segs = tmk.trace_regenerative_mega(port, cam, pix, samp, 3, **KW)
    # Born-dead pad lanes (sample 0xFFFFFFFF) appended to the batch.
    pad_pix = torch.cat([pix, torch.arange(100)])
    pad_samp = torch.cat([samp, torch.full((100,), 0xFFFFFFFF)])
    padded, padded_segs = tmk.trace_regenerative_mega(port, cam, pad_pix,
                                                      pad_samp, 3, **KW)
    assert int(padded_segs) == int(base_segs)
    for a, b in zip(base, padded):
        assert torch.equal(a, b[:W * H]) and torch.all(b[W * H:] == 0)
    # radiance_batch's lane_mask: masked pixels add no radiance, no segments.
    mask = torch.arange(W * H) % 3 != 0
    kw = dict(width=W, height=H, sample_start=0, n_samples=SPP, spp_cap=SPP,
              samples_per_pass=1, max_depth=DEPTH, t_min=1e-3)
    full, _ = _radiance_batch(port, cam, pix, **kw)
    masked, masked_segs = _radiance_batch(port, cam, pix, lane_mask=mask, **kw)
    only, only_segs = _radiance_batch(port, cam, pix[mask], **kw)
    assert int(masked_segs) == int(only_segs)
    for a, b, c in zip(full, masked, only):
        assert torch.all(b[~mask] == 0)
        assert torch.equal(b[mask], c) and torch.equal(b[mask], a[mask])


def test_supports_matches_reference():
    cases = [jlib.cornell_box(), jlib.two_spheres(), jlib.two_perlin_spheres(),
             jlib.simple_light(), jlib.cornell_smoke(), jlib.final_scene(),
             _metal_scene()]
    verdicts = []
    for ref, params in cases:
        ref_cam = jcam.make_camera(aspect_ratio=1.0, **params)
        port = tscene.scene_from_reference(ref)
        cam = tcam.camera_from_reference(ref_cam)
        verdicts.append(tmk.supports(port, cam))
        assert verdicts[-1] == jmk.supports(ref, ref_cam)
    assert verdicts == [True, True, False, False, False, False, True]
    with pytest.raises(ValueError, match="not supported"):
        tmk.trace_regenerative_mega(tscene.scene_from_reference(cases[2][0]),
                                    cam, *_lanes(), 0, **KW)

