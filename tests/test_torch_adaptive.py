"""Port vs JAX: the adaptive render mode on one device (``ops/adaptive.py``).

The same scene, camera and config go through the JAX ``render_adaptive``
(the XLA wavefront on the CPU) and the port's (the megakernel's plain
version: K1's on the Cornell box, K3's on the sphere tree).  Both decide the
subdivision of each level from the traced corners' colours, so a pixel whose
path flips between the packages at an edge (tests/test_mega.py:37-45) can
flip a square.  The bar: each level's subdivision masks equal on >= 98% of
its squares, and the uint8 images equal on >= 98% of pixels.  The port's
megakernel takes sphere hits as ``o + t d`` there, as JAX's does
(``megakernel_like_jax``, tests/jax_sphere_record.py).
"""

import numpy as np
import pytest
import torch

from another_raytracer_tpu.config import RenderConfig as JConfig
from another_raytracer_tpu.config import RenderMode as JMode
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import adaptive as jadaptive
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import adaptive as tadaptive
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import kernels as tkernels
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

W, H, SPP, DEPTH = 48, 36, 4, 5


def _forty_spheres():
    """40 spheres in one BVH (sphere_bvh=True below the auto threshold):
    checker ground, lambertian, metal and dielectric spheres."""
    rng = np.random.default_rng(6)
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=3)
    b.sphere((0, -1000, 0), 1000, b.lambertian(
        texture=b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    for i in range(39):
        c = (rng.uniform(-4, 4), rng.uniform(0.2, 0.6), rng.uniform(-6, 0))
        if i % 5 == 0:
            m = b.metal(tuple(rng.uniform(0.5, 1.0, 3)), rng.uniform(0, 0.3))
        elif i % 5 == 1:
            m = b.dielectric(1.5)
        else:
            m = b.lambertian(color=tuple(rng.uniform(0.1, 0.9, 3)))
        b.sphere(c, 0.35, m)
    return b.build(sphere_bvh=True), dict(lookfrom=(0, 2, 4), lookat=(0, 0.3, -3),
                                          vfov=50.0)


SCENES = {"cornell_box": jlib.cornell_box, "forty_spheres": _forty_spheres}


def _masks(monkeypatch, module):
    """Record every subdivision mask ``module.render_adaptive`` computes."""
    masks = []
    orig = module._heuristic

    def spy(*a, **k):
        masks.append(np.asarray(orig(*a, **k)))
        return masks[-1]

    monkeypatch.setattr(module, "_heuristic", spy)
    return masks


@pytest.mark.parametrize("name", list(SCENES))
def test_adaptive_matches_jax(name, monkeypatch, megakernel_like_jax):
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    port = tscene.scene_from_reference(ref, device="cpu")
    cam = tcam.camera_from_reference(ref_cam, device="cpu")
    assert (tmk.supports_accel if name == "forty_spheres"
            else tmk.supports)(port, cam)
    cfg = dict(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH,
               seed=2)
    jmasks, tmasks = _masks(monkeypatch, jadaptive), _masks(monkeypatch,
                                                            tadaptive)
    # JAX on one device (its default spreads the batches over every visible
    # device, here the test configuration's 8 CPU devices).
    devices = jadaptive.jax.devices
    monkeypatch.setattr(jadaptive.jax, "devices", lambda *a: devices(*a)[:1])
    want, wstats = jrender.render(ref, ref_cam, JConfig(mode=JMode.ADAPTIVE,
                                                        **cfg))
    got, gstats = trender.render(port, cam, RenderConfig(
        mode=RenderMode.ADAPTIVE, **cfg))
    assert got.shape == (H, W, 3) and got.dtype == np.uint8
    assert len(tmasks) == len(jmasks) == 3
    for level, (jm, tm) in enumerate(zip(jmasks, tmasks)):
        # A flipped square above changes the squares below it.
        if jm.shape != tm.shape:
            assert level > 0
            continue
        assert (jm == tm).mean() >= 0.98, level
    assert tmasks[0].any() and not tmasks[0].all()
    assert (np.asarray(want) == got).all(axis=-1).mean() >= 0.98
    assert abs(gstats["traced_pixels"] - wstats["traced_pixels"]) <= 0.02 * W * H
    assert 0 < gstats["traced_pixels"] < W * H and gstats["segments"] > 0
    assert gstats["total_pixels"] == W * H


def test_adaptive_traced_pixels_equal_the_single_render():
    """Traced pixels take the single render's colours exactly: the adaptive
    batches go through the same kernel with the same (pixel, sample) keys."""
    scene, params = tlib.random_scene(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    cfg = dict(width=W, height=H, samples_per_pixel=2, max_depth=DEPTH, seed=4)
    before = tkernels.launch_counts()["K1"]
    img, stats = trender.render(scene, cam, RenderConfig(
        mode=RenderMode.ADAPTIVE, **cfg))
    exact, _ = trender.render(scene, cam, RenderConfig(**cfg))
    assert tkernels.launch_counts()["K1"] == before  # CPU: plain versions
    corners = np.zeros((H, W), bool)
    corners[0::12, 0::12] = corners[11::12, 0::12] = True
    corners[0::12, 11::12] = corners[11::12, 11::12] = True
    assert np.array_equal(img[corners], exact[corners])
    assert stats["traced_pixels"] < W * H


def test_adaptive_contract_errors(tmp_path):
    scene, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=1.0, device="cpu", **params)
    cfg = RenderConfig(width=50, height=36, samples_per_pixel=2, max_depth=2,
                       mode=RenderMode.ADAPTIVE)
    with pytest.raises(ValueError, match="perfectly fit"):
        trender.render(scene, cam, cfg)
    with pytest.raises(TypeError, match="Partition"):
        tadaptive.render_adaptive(scene, cam, cfg.replace(width=48),
                                  partition=object())
    with pytest.raises(SystemExit):
        cli.main(["--scene", "6", "--width", "50", "--height", "36", "--mode",
                  "adaptive", "--device", "cpu", "--out",
                  str(tmp_path / "x.png")])


def test_cli_adaptive_on_scene1(tmp_path, capsys):
    out = tmp_path / "scene1.png"
    rc = cli.main(["--scene", "1", "--width", "24", "--height", "24",
                   "--spp", "2", "--max-depth", "4", "--mode", "adaptive",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0 and out.exists()
    printed = capsys.readouterr().out
    assert "mode=adaptive" in printed and "segments" in printed
