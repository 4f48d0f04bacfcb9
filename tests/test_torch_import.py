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
from another_raytracer_tpu_torch import bench, cli
from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.ops import bvh, camera, integrator, render, shade
from another_raytracer_tpu_torch.ops.kernels import (_build, bvh_kernel,
                                                     mega_diff, mega_kernel,
                                                     perlin_kernel)
from another_raytracer_tpu_torch.utils import assets

scene, params = library.cornell_box(device="cpu")
cam = camera.make_camera(aspect_ratio=1.0, device="cpu", **params)
img, stats = render.render(
    scene, cam, RenderConfig(width=12, height=12, samples_per_pixel=1))
assert img.shape == (12, 12, 3) and stats["segments"] > 0, stats
leaves, _ = diff.split_params(scene)
loss, grads = diff.render_value_and_grad(
    leaves, scene, cam, torch.zeros(144, 3), 0, width=12, height=12, spp=2,
    samples_per_pass=1, max_depth=3, t_min=1e-3)
assert float(grads["tex_ca"].abs().max()) > 0
# The wavefront of the BVH and noise scenes: scene 1's sphere tree and
# scene 3's Perlin noise, through the plain versions of K5 and K4.
for alias in (1, 3):
    scene, params = library.build(alias, device="cpu")
    cam = camera.make_camera(aspect_ratio=1.0, device="cpu", **params)
    img, st = render.render(
        scene, cam, RenderConfig(width=8, height=8, samples_per_pixel=1,
                                 max_depth=4))
    assert img.shape == (8, 8, 3) and st["segments"] > 0, st
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
