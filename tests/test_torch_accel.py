"""Port vs JAX: the megakernel's accel mode (K3) and the forward routing
(``MEGA_FORWARD`` / ``enabled``).

K3's plain version is held against the Pallas kernel in accel mode
(interpret) with the bar of tests/test_mega.py:37-45 (segment drift <=
max(4, 1%), <= 2% of lane values off by more than 2e-2, median difference
< 1e-5), on the 81-sphere tree of tests/test_mega.py:74-95 and on scene 1
(the random scene: 871 spheres, 485 textures, lens and motion), with the
port's re-projection of sphere hits taken out (``megakernel_like_jax``,
tests/jax_sphere_record.py: the Pallas kernel takes ``o + t d``).  Its record
instance and the fused gradients are tests/test_torch_accel_diff.py's.
"""

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
from another_raytracer_tpu_torch.ops import integrator
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from test_mega import _bvh_sphere_scene
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

W, H, SPP, DEPTH = 24, 18, 4, 5


def _seventy_spheres():
    # tests/test_mega_diff.py:212-232: 71 spheres in one tree, 71 textures
    # (> MAX_TEXTURES), checker ground, metal, dielectric, motion.
    rng = np.random.default_rng(9)
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=5)
    ground = b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9)))
    b.sphere((0, -1000, 0), 1000, ground)
    for i in range(70):
        c = (rng.uniform(-5, 5), rng.uniform(0.2, 0.5), rng.uniform(-5, 2))
        if i % 9 == 0:
            b.sphere(c, 0.25, b.metal(color=tuple(rng.uniform(0.5, 1, 3)),
                                      fuzz=rng.uniform(0, 0.4)))
        elif i % 9 == 1:
            b.sphere(c, 0.25, b.dielectric(1.5))
        elif i % 7 == 0:
            b.moving_sphere(c, (c[0], c[1] + 0.3, c[2]), 0.0, 1.0, 0.2,
                            b.lambertian(color=tuple(rng.uniform(0, 1, 3))))
        else:
            b.sphere(c, 0.25,
                     b.lambertian(color=tuple(rng.uniform(0, 1, 3))))
    return b.build(sphere_bvh=True), dict(
        lookfrom=(8, 2, 3), lookat=(0, 0.3, -1), vfov=25, time0=0.0, time1=1.0)


SCENES = {"bvh_sphere_scene": _bvh_sphere_scene,
          "random_scene": jlib.random_scene,
          "seventy_spheres": _seventy_spheres}
# JAX's accel block for the interpret runs: scene 1's own (8192 on the TPU
# bench) would pad 432 lanes to 8192.
JAX_BLOCK = {"random_scene": dict(block=1024)}


def _both(name, width=W, height=H):
    """(JAX scene, JAX camera), (port scene, port camera) for one scene."""
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=width / height, **params)
    return ((ref, ref_cam), (tscene.scene_from_reference(ref, device="cpu"),
                             tcam.camera_from_reference(ref_cam, device="cpu")))


def _kw(spp=SPP, depth=DEPTH, record_iters=0):
    return dict(width=W, height=H, sample_stride=1, sample_end=spp,
                spp_cap=spp, max_depth=depth, t_min=1e-3,
                record_iters=record_iters)


def _run_both(name, **kw):
    """(JAX scene, the Pallas kernel's result, the port's result)."""
    (ref, ref_cam), (port, cam) = _both(name)
    want = jmk.trace_regenerative_mega(
        ref, ref_cam, jnp.arange(W * H, dtype=jnp.uint32),
        jnp.zeros(W * H, jnp.uint32), jnp.uint32(3), interpret=True,
        **JAX_BLOCK.get(name, {}), **kw)
    got = tmk.trace_regenerative_mega(port, cam, torch.arange(W * H),
                                      torch.zeros(W * H, dtype=torch.int64), 3,
                                      **kw)
    return ref, want, got


def _forward_bar(want, got):
    w, g = jvec3.to_numpy(want[0]), tvec3.to_numpy(got[0])
    assert abs(int(got[1]) - int(want[1])) <= max(4, 0.01 * int(want[1]))
    diff = np.abs(g - w)
    assert (diff > 2e-2).mean() <= 0.02, f"max {diff.max():.2e}"
    assert np.median(diff) < 1e-5
    assert g.mean() > 0


@pytest.mark.parametrize("name", ["bvh_sphere_scene", "random_scene"])
def test_plain_accel_matches_pallas(name, megakernel_like_jax):
    (ref, ref_cam), (port, cam) = _both(name)
    assert tmk.supports_accel(port, cam) and jmk.supports_accel(ref, ref_cam)
    assert not tmk.supports(port, cam)
    np.testing.assert_allclose(
        tmk.pack_accel_rows(port).numpy(),
        np.concatenate([np.asarray(ref.sph_bvh_rows), np.asarray(jmk._mat_cols(
            ref, ref.sph_mat[np.clip(np.asarray(ref.sph_bvh_rows[:, 9]).astype(
                np.int32) // 4, 0, ref.n_spheres - 1)]))], axis=1), rtol=0,
        atol=0)
    _forward_bar(*_run_both(name, **_kw())[1:])


@pytest.fixture
def forward_flag():
    """Set the port's MEGA_FORWARD inside a test, restored after."""
    saved = tmk.MEGA_FORWARD

    def set_flag(value):
        tmk.MEGA_FORWARD = value

    yield set_flag
    tmk.MEGA_FORWARD = saved


def test_mega_forward_routing(forward_flag, monkeypatch):
    """MEGA_FORWARD None (auto) / True / False decide the forward route of
    radiance_batch, with JAX's semantics: True raises on a scene neither
    mode supports, False sends every render to the wavefront."""
    routes = []
    for mod, fn, tag in ((tmk, "trace_regenerative_mega", "mega"),
                         (integrator, "trace_regenerative", "wavefront")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _t=tag, **k: (
            routes.append(_t), _o(*a, **k))[1])
    scenes = {"random": tlib.random_scene(device="cpu"),
              "cornell": tlib.cornell_box(device="cpu"),
              "perlin": tlib.two_perlin_spheres(device="cpu")}
    kw = dict(width=8, height=6, sample_start=0, n_samples=1, spp_cap=1,
              samples_per_pass=1, max_depth=2, t_min=1e-3)
    for forward, want in ((None, ["mega", "mega", "wavefront"]),
                          (True, ["mega", "mega", ValueError]),
                          (False, ["wavefront"] * 3)):
        forward_flag(forward)
        for (scene, params), expect in zip(scenes.values(), want):
            cam = tcam.make_camera(aspect_ratio=8 / 6, device="cpu", **params)
            routes.clear()
            if expect is ValueError:
                with pytest.raises(ValueError, match="MEGA_FORWARD"):
                    trender.radiance_batch(scene, cam, torch.arange(48), 0,
                                           **kw)
                continue
            assert tmk.enabled(scene, cam) == (expect == "mega")
            trender.radiance_batch(scene, cam, torch.arange(48), 0, **kw)
            assert routes == [expect]


def test_supports_accel_matches_reference():
    cases = [jlib.cornell_box(), jlib.two_spheres(), jlib.two_perlin_spheres(),
             jlib.random_scene(), jlib.simple_light(), _bvh_sphere_scene(),
             _seventy_spheres()]
    verdicts = []
    for ref, params in cases:
        ref_cam = jcam.make_camera(aspect_ratio=1.0, **params)
        port = tscene.scene_from_reference(ref, device="cpu")
        cam = tcam.camera_from_reference(ref_cam, device="cpu")
        verdicts.append(tmk.supports_accel(port, cam))
        assert verdicts[-1] == jmk.supports_accel(ref, ref_cam)
        assert tmk.supports(port, cam) == jmk.supports(ref, ref_cam)
    assert verdicts == [False, False, False, True, False, True, True]
    assert tmk.ACCEL_MAX_ROWS == jmk.ACCEL_MAX_ROWS


def test_accel_pad_lanes_are_born_dead():
    """Lanes that start at sample 0xFFFFFFFF (radiance_batch's lane_mask)
    trace nothing in K3: no radiance, no segments."""
    port, params = tlib.random_scene(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    pix = torch.arange(W * H)
    kw = dict(width=W, height=H, sample_start=0, n_samples=2, spp_cap=2,
              samples_per_pass=1, max_depth=DEPTH, t_min=1e-3)
    mask = pix % 3 != 0
    full, _ = trender.radiance_batch(port, cam, pix, 3, **kw)
    masked, masked_segs = trender.radiance_batch(port, cam, pix, 3,
                                                 lane_mask=mask, **kw)
    only, only_segs = trender.radiance_batch(port, cam, pix[mask], 3, **kw)
    assert int(masked_segs) == int(only_segs) > 0
    for a, b, c in zip(full, masked, only):
        assert torch.all(b[~mask] == 0)
        assert torch.equal(b[mask], c) and torch.equal(b[mask], a[mask])
