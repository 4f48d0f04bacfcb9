"""The port must import and render with JAX and flax unavailable — the
machine with the GPU has neither — and must not load the JAX package."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
torch.set_num_threads(1)
import chip_smoke
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera, render
from another_raytracer_tpu_torch.ops.kernels import _build, mega_kernel

scene, params = library.cornell_box()
cam = camera.make_camera(aspect_ratio=1.0, **params)
img, stats = render.render(
    scene, cam, RenderConfig(width=12, height=12, samples_per_pixel=1))
assert img.shape == (12, 12, 3) and stats["segments"] > 0, stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "jaxlib",
                                    "another_raytracer_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok", stats["segments"])
"""


def test_port_imports_and_renders_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok ")
