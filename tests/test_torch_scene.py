"""Port vs JAX: scene construction, scene transfer and the camera."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import vec3 as tvec3

torch.set_num_threads(1)

W, H = 24, 18
LENS_SHUTTER = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
                    aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)


def _assert_scene_equal(port, ref):
    for f in dataclasses.fields(tscene.SceneData):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in tscene.STATIC_FIELDS:
            assert got == want, f.name
        else:
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


def _metal_builder(builder_cls):
    b = builder_cls(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    xf = b.transform(rotate_y_deg=30, translate=(1, 0, 0))
    b.box((0, 0, 0), (0.3, 0.3, 0.3), b.diffuse_light(color=(4, 4, 4)), xform=xf)
    return b


@pytest.mark.parametrize("name", ["cornell_box", "two_spheres"])
def test_library_scene_equals_reference(name):
    port, port_cam = getattr(tlib, name)()
    ref, ref_cam = getattr(jlib, name)()
    _assert_scene_equal(port, ref)
    assert port_cam == ref_cam


def test_builder_and_scene_from_reference_round_trip():
    ref = _metal_builder(JBuilder).build()
    port = _metal_builder(tscene.SceneBuilder).build()
    _assert_scene_equal(port, ref)
    carried = tscene.scene_from_reference(ref)
    _assert_scene_equal(carried, ref)
    assert carried.has_motion and not carried.has_accel
    assert carried.to("cpu").background.device.type == "cpu"


def test_builder_refuses_unported():
    b = tscene.SceneBuilder()
    m = b.lambertian(color=(0.5, 0.5, 0.5))
    for i in range(64):
        b.sphere((i, 0, 0), 0.4, m)
    with pytest.raises(NotImplementedError, match="M16"):
        b.build()
    with pytest.raises(NotImplementedError, match="not ported"):
        tlib.build(9)
    with pytest.raises(ValueError, match="unknown scene"):
        tlib.build(12)


def _cameras(params):
    ref = jcam.make_camera(aspect_ratio=W / H, **params)
    return tcam.make_camera(aspect_ratio=W / H, **params), ref


@pytest.mark.parametrize("params", [LENS_SHUTTER, jlib.cornell_box()[1]],
                         ids=["lens_shutter", "cornell"])
def test_make_camera_matches_reference(params):
    port, ref = _cameras(params)
    for k in ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "lens_radius", "time0", "time1"):
        np.testing.assert_allclose(getattr(port, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-6,
                                   atol=0, err_msg=k)
    assert (port.has_lens, port.has_time) == (ref.has_lens, ref.has_time)
    carried = tcam.camera_from_reference(ref)
    np.testing.assert_array_equal(carried.lower_left.numpy(),
                                  np.asarray(ref.lower_left))
    assert carried.has_lens == ref.has_lens


def test_generate_rays_matches_reference():
    port, ref = _cameras(LENS_SHUTTER)
    assert port.has_lens and port.has_time
    rng = np.random.default_rng(0)
    pix = rng.integers(0, W * H, 2 * W * H).astype(np.uint32)
    samp = rng.integers(0, 64, 2 * W * H).astype(np.uint32)
    want = jcam.generate_rays(ref, jnp.asarray(pix), jnp.asarray(samp), W, H,
                              jnp.uint32(9))
    got = tcam.generate_rays(port, torch.from_numpy(pix.astype(np.int64)),
                             torch.from_numpy(samp.astype(np.int64)), W, H, 9)
    for a, b in zip(want[:2], got[:2]):
        np.testing.assert_allclose(tvec3.to_numpy(b), jvec3.to_numpy(a),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-5)
    # The shutter draw is skipped when nothing moves; it shifts no other draw.
    static = tcam.generate_rays(port, torch.from_numpy(pix.astype(np.int64)),
                                torch.from_numpy(samp.astype(np.int64)), W, H,
                                9, needs_time=False)
    assert torch.equal(static[1].x, got[1].x)
    assert torch.all(static[2] == 0.0)
