"""Port vs JAX: the progressive render with preview and checkpoint / resume
(``utils/preview.py``), and the progress sink of ``render.render``.

Bars: the progressive image against JAX's ``render_progressive`` as
tests/test_torch_render.py holds single mode (>= 98% of uint8 channels
within 2; segments within max(4, 1%)), the port's megakernel taking sphere
hits as ``o + t d`` as JAX's path does (``megakernel_like_jax``,
tests/jax_sphere_record.py); resume bit-equal to an uninterrupted run (the
float64 accumulator is saved exactly).
"""

import warnings

import numpy as np
import pytest
import torch

from another_raytracer_tpu.config import RenderConfig as JConfig
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.utils import preview as jpreview
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.utils import imageio
from another_raytracer_tpu_torch.utils import preview
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

W, H = 24, 12
CFG = dict(width=W, height=H, samples_per_pixel=4, max_depth=4,
           samples_per_pass=1, seed=3)


def _scene(builder, **kw):
    # tests/test_preview_checkpoint.py's scene.
    b = builder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.1))
    return b.build(**kw)


CAM = dict(lookfrom=(0, 0, 1), lookat=(0, 0, -1), vfov=60, aspect_ratio=W / H)


@pytest.fixture(scope="module")
def port():
    return _scene(SceneBuilder, device="cpu"), tcam.make_camera(device="cpu",
                                                                **CAM)


def test_progressive_matches_jax(port, tmp_path, megakernel_like_jax):
    scene, cam = port
    png = tmp_path / "preview.png"
    prev = preview.ProgressivePreview(str(png), W, H, interval=2)
    img, stats = preview.render_progressive(scene, cam, RenderConfig(**CFG),
                                            prev)
    want, want_stats = jpreview.render_progressive(
        _scene(JBuilder), jcam.make_camera(**CAM), JConfig(**CFG))
    close = np.abs(img.astype(int) - np.asarray(want).astype(int)) <= 2
    assert img.shape == (H, W, 3) and close.mean() >= 0.98
    assert abs(stats["segments"] - want_stats["segments"]) <= max(
        4, 0.01 * want_stats["segments"])
    # Every second pass wrote the snapshot; the last one is the final image.
    assert prev._count == 4
    np.testing.assert_array_equal(imageio.load_png(png), img)
    # Against single mode: the same samples, summed in float64 per pass.
    single, single_stats = trender.render(scene, cam, RenderConfig(**CFG))
    assert (img != single).mean() < 0.001
    assert stats["segments"] == single_stats["segments"]


def test_checkpoint_resume_is_bit_exact(port, tmp_path):
    scene, cam = port
    cfg = RenderConfig(**CFG)
    full = preview.RenderCheckpoint(str(tmp_path / "full.npz"))
    img_full, st = preview.render_progressive(scene, cam, cfg, None, full)
    assert st["resumed_at_chunk"] == 0
    # Interrupted after 2 of 4 passes, then resumed in a new call.
    half = preview.RenderCheckpoint(str(tmp_path / "half.npz"))
    preview.render_progressive(scene, cam, cfg.replace(samples_per_pixel=2),
                               None, half)
    state = half.load()
    assert int(state["samples_done"]) == 2
    assert sorted(state) == ["fingerprint", "height", "radiance",
                             "samples_done", "seed", "width"]
    img, st = preview.render_progressive(scene, cam, cfg, None, half)
    assert st["resumed_at_chunk"] == 2
    np.testing.assert_array_equal(img, img_full)
    np.testing.assert_array_equal(half.load()["radiance"],
                                  full.load()["radiance"])


def test_fingerprint_mismatch_warns_and_starts_fresh(port, tmp_path):
    scene, cam = port
    cfg = RenderConfig(**CFG)
    ckpt = preview.RenderCheckpoint(str(tmp_path / "state.npz"))
    img, _ = preview.render_progressive(scene, cam, cfg, None, ckpt)
    other = cfg.replace(seed=4)
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        img2, st = preview.render_progressive(scene, cam, other, None, ckpt)
    assert st["resumed_at_chunk"] == 0
    fresh, _ = preview.render_progressive(scene, cam, other)
    np.testing.assert_array_equal(img2, fresh)
    assert preview.render_fingerprint(scene, cam, cfg) == \
        preview.render_fingerprint(scene, cam, cfg.replace(
            samples_per_pixel=64))
    assert preview.render_fingerprint(scene, cam, cfg) != \
        preview.render_fingerprint(scene, cam, cfg.replace(max_depth=5))
    moved = scene.replace(background=scene.background + 0.1)
    assert preview.render_fingerprint(scene, cam, cfg) != \
        preview.render_fingerprint(moved, cam, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ckpt.load() is not None  # no fingerprint asked: no check


def test_fingerprint_ignores_packed_tables():
    """A render fills the scene's packed kernel tables (scene 8: K5's rect
    and sphere trees; on the card also K4's Perlin tables); the fingerprint
    reads only the dataclass fields, so a resume after one pass still
    matches."""
    scene, params = tlib.final_scene(device="cpu")
    cam = tcam.make_camera(aspect_ratio=1.0, device="cpu", **params)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, max_depth=2)
    before = preview.render_fingerprint(scene, cam, cfg)
    assert not scene.__dict__.get("_packed")
    preview.render_progressive(scene, cam, cfg)
    assert {k[:2] for k in scene.__dict__["_packed"]} == {("k5", "rect"),
                                                           ("k5", "sphere")}
    assert preview.render_fingerprint(scene, cam, cfg) == before


def test_single_and_adaptive_feed_a_sink(port):
    scene, cam = port
    frames = []

    class Sink:
        def update_image(self, img, progress):
            frames.append((img.copy(), progress))

    img, _ = trender.render(scene, cam, RenderConfig(**CFG), progress=Sink())
    assert len(frames) == 1 and frames[0][1] == 4
    np.testing.assert_array_equal(frames[0][0], img)
    frames.clear()
    cfg = RenderConfig(**dict(CFG, width=24, height=12),
                       mode=RenderMode.ADAPTIVE)
    img, stats = trender.render(scene, cam, cfg, progress=Sink())
    # One frame per level (three) and the final image.
    assert len(frames) == 4
    np.testing.assert_array_equal(frames[-1][0], img)
    assert frames[-1][1] == stats["traced_pixels"]
    assert (frames[0][0] == 0).any()  # pixels not decided yet show black


def test_cli_preview_checkpoint_and_profile(tmp_path, capsys):
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.utils import profiling

    out, png, ckpt = (str(tmp_path / n) for n in ("o.png", "p.png", "c.npz"))
    argv = ["--scene", "6", "--width", "16", "--height", "12", "--spp", "2",
            "--max-depth", "3", "--mode", "single", "--device", "cpu",
            "--out", out, "--preview", png, "--checkpoint", ckpt,
            "--profile-dir", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    img = imageio.load_png(out)
    np.testing.assert_array_equal(imageio.load_png(png), img)
    state = np.load(ckpt)
    assert int(state["samples_done"]) == 2 and state["radiance"].shape == \
        (16 * 12, 3)
    # The CPU trace holds host activity only: no device time to read.
    with pytest.raises(RuntimeError, match="no device activity"):
        profiling.device_seconds(str(tmp_path / "trace"))
    # A second run resumes the finished checkpoint: the same image, no pass.
    capsys.readouterr()
    assert cli.main(argv[:-2]) == 0
    assert "0 segments" in capsys.readouterr().out
    np.testing.assert_array_equal(imageio.load_png(out), img)


def test_timed_and_ray_stats():
    """``timed`` yields the region's seconds and sends one line to its sink;
    ``RayStats`` sums segments and seconds into Mrays/s (the CLI's line)."""
    import time

    from another_raytracer_tpu_torch.utils import profiling

    lines = []
    with profiling.timed("work", sink=lines.append) as timing:
        time.sleep(0.01)
    assert timing.seconds >= 0.01
    assert lines == [f"work: {timing.seconds * 1000:.1f} ms"]
    with profiling.timed("quiet", sink=None) as quiet:
        pass
    assert 0 <= quiet.seconds < timing.seconds
    rays = profiling.RayStats()
    rays.add(3_000_000, 1.5)
    rays.add(1_000_000, 0.5)
    assert (rays.segments, rays.seconds, rays.mrays_per_s) == (4_000_000, 2.0,
                                                               2.0)
    assert profiling.RayStats().mrays_per_s == 0.0
