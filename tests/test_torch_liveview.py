"""The port's live HTTP viewer (``utils/liveview.py``) against the JAX
package's: the page, ``/frame.png`` (the same PNG bytes as JAX's encoder),
``/status``, the progressive preview feeding it, and ``--live`` through
the CLI on localhost."""

import json
import urllib.request

import numpy as np
import torch

from another_raytracer_tpu.utils import imageio as jimageio
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.utils import imageio, preview
from another_raytracer_tpu_torch.utils.liveview import LiveViewer

torch.set_num_threads(1)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read(), r.headers.get("Content-Type")


def test_viewer_serves_page_frame_and_status():
    v = LiveViewer(port=0)
    port = v.start()
    try:
        assert port > 0 and v.url == f"http://127.0.0.1:{port}/"
        img = np.zeros((4, 6, 3), np.uint8)
        img[..., 0] = 123
        v.update(img, samples_done=7)
        page, ctype = _get(v.url)
        assert ctype.startswith("text/html") and b"frame.png" in page
        png, ctype = _get(v.url + "frame.png")
        assert ctype == "image/png" and png == jimageio._encode_png(img)
        np.testing.assert_array_equal(imageio._decode_png(png), img)
        status, _ = _get(v.url + "status")
        assert json.loads(status) == {"updates": 1, "samples_done": 7}
        v.update(img * 0 + 9, samples_done=9)
        assert _get(v.url + "frame.png?1")[0] != png
    finally:
        v.stop()


def test_progressive_preview_pushes_to_viewer():
    W, H = 24, 12
    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    scene = b.build(device="cpu")
    cam = tcam.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1), vfov=60,
                           aspect_ratio=W / H, device="cpu")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4, max_depth=3,
                       samples_per_pass=2, seed=3)
    v = LiveViewer(port=0)
    v.start()
    try:
        prev = preview.ProgressivePreview(None, W, H, viewer=v)
        img, _ = preview.render_progressive(scene, cam, cfg, prev, None)
        status, _ = _get(v.url + "status")
        assert json.loads(status) == {"updates": 2, "samples_done": 4}
        png, _ = _get(v.url + "frame.png")
        np.testing.assert_array_equal(imageio._decode_png(png), img)
    finally:
        v.stop()


def test_cli_live_streams_and_stops(tmp_path, capsys):
    for mode in ("adaptive", "single"):
        out = tmp_path / f"{mode}.png"
        rc = cli.main(["--scene", "6", "--width", "24", "--height", "12",
                       "--spp", "2", "--max-depth", "3", "--mode", mode,
                       "--live", "0", "--device", "cpu", "--out", str(out)])
        printed = capsys.readouterr().out
        assert rc == 0 and out.exists() and "live view at http://127.0.0.1:" \
            in printed
        url = printed.split("live view at ")[1].split()[0]
        # stop() closed the server after the render.
        try:
            _get(url + "status")
            raise AssertionError("the viewer still serves after the CLI")
        except OSError:
            pass
