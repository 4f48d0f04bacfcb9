"""Port vs JAX: single-mode render end to end, the CLI, and the NotImplemented
gates.  On the CPU the JAX render runs the XLA wavefront
(integrator.trace_regenerative at spp > 1, the lockstep scan at spp 1) and
the port runs the megakernel's plain version; the bar is that of
tests/test_mega.py:37-45 on the radiance sums, plus >= 98% of uint8 channels
within 2."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.config import RenderConfig as JConfig
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.utils import imageio

torch.set_num_threads(1)

W, H, DEPTH = 24, 18, 5


@pytest.mark.parametrize("spp", [4, 1])
def test_render_matches_reference(spp):
    cfg = dict(width=W, height=H, samples_per_pixel=spp, max_depth=DEPTH, seed=2)
    ref_scene, params = jlib.cornell_box()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    port_scene, _ = tlib.cornell_box(device="cpu")
    port_cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    kw = dict(width=W, height=H, spp=spp, samples_per_pass=1,
              max_depth=DEPTH, t_min=1e-3)

    want, want_segs = jrender.render_radiance(ref_scene, ref_cam,
                                              jnp.uint32(2), **kw)
    got, got_segs = trender.render_radiance(port_scene, port_cam, 2, **kw)
    assert abs(int(got_segs) - int(want_segs)) <= max(4, 0.01 * int(want_segs))
    diff = np.abs(tvec3.to_numpy(got) - jvec3.to_numpy(want))
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5

    want_img, want_stats = jrender.render(ref_scene, ref_cam, JConfig(**cfg))
    got_img, got_stats = trender.render(port_scene, port_cam, RenderConfig(**cfg))
    assert got_img.shape == (H, W, 3) and got_img.dtype == np.uint8
    close = np.abs(got_img.astype(int) - np.asarray(want_img).astype(int)) <= 2
    assert close.mean() >= 0.98
    assert got_stats["segments"] == int(got_segs)


def test_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    rc = cli.main(["--scene", "6", "--width", "16", "--height", "12",
                   "--spp", "2", "--max-depth", "4", "--mode", "single",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0 and os.path.getsize(out) > 0
    img = imageio.load_png(out)
    assert img.shape == (12, 16, 3) and img.dtype == np.uint8
    assert "segments" in capsys.readouterr().out


def test_unported_paths_raise(tmp_path):
    scene, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    for mode, item in [(RenderMode.ADAPTIVE, "M19"),
                       (RenderMode.PARALLEL_STRIPES, "M18"),
                       (RenderMode.PARALLEL_IMAGES, "M18")]:
        with pytest.raises(NotImplementedError, match=item):
            trender.render(scene, cam, RenderConfig(width=W, height=H,
                                                    mode=mode))
    # Forward and differentiable renders of a scene with a medium: no
    # integrator traces media yet.
    b = SceneBuilder(background=(0.5, 0.6, 0.8), seed=3)
    b.sphere((0, 0, -2), 1.0, b.lambertian(texture=b.noise_texture(2.0)))
    b.constant_medium_sphere((0, 0, -2), 2.0, 0.5, color=(1, 1, 1))
    for differentiable in (False, True):
        with pytest.raises(NotImplementedError, match="M15"):
            trender.radiance_batch(b.build(device="cpu"), cam,
                                   torch.arange(W * H), 0, width=W, height=H,
                                   sample_start=0, n_samples=1, spp_cap=1,
                                   samples_per_pass=1, max_depth=2, t_min=1e-3,
                                   differentiable=differentiable)
    for alias, item in ((7, "M15"), (8, "M15"), (9, "M17")):
        with pytest.raises(NotImplementedError, match=item):
            tlib.build(alias, device="cpu")
    out = str(tmp_path / "x.png")
    # The JAX CLI's defaults (--scene 9 --mode adaptive) are not ported yet.
    for argv in ([], ["--mode", "single", "--scene", "9"],
                 ["--mode", "single", "--scene", "6", "--live"],
                 ["--mode", "single", "--scene", "6", "--obj", "x.obj"]):
        with pytest.raises(SystemExit):
            cli.main(argv + ["--width", "8", "--height", "6", "--spp", "1",
                             "--device", "cpu", "--out", out])
    assert not os.path.exists(out)


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--scene", "6", "--mode", "single", "--device", "cuda",
                  "--out", str(tmp_path / "x.png")])
    scene, params = tlib.cornell_box(device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        scene.to("cuda")
    # The builders and the camera default to the card.
    for build in (lambda: tlib.build(1), lambda: tlib.cornell_box(),
                  lambda: tcam.make_camera(**params)):
        with pytest.raises((RuntimeError, AssertionError)):
            build()
