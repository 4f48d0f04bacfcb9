"""The port must import and render with JAX and flax unavailable — the
machine with the GPU has neither — and must not load the JAX package
(its modules, ``bench_extra``, ``trace_scene`` and ``scaling_harness``
included)."""

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
from another_raytracer_tpu_torch import (bench, bench_extra, cli,
                                         scaling_harness, train_demo,
                                         trace_scene)
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.ops import bvh, camera, integrator, render, shade
from another_raytracer_tpu_torch.ops.kernels import (_build, bvh_kernel,
                                                     mega_diff, mega_kernel,
                                                     perlin_kernel)
from another_raytracer_tpu_torch.parallel import multihost, sharding
from another_raytracer_tpu_torch.utils import (assets, imageio, liveview,
                                               native, preview, profiling)

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
# The new entry points: stripes over two CPU shards, a progressive render,
# the host library's parser.
img2, st2 = render.render(
    scene, cam, RenderConfig(width=12, height=12, samples_per_pixel=1,
                             mode=RenderMode.PARALLEL_STRIPES),
    partition=sharding.hybrid_partition(devices=["cpu", "cpu"]))
assert img2.shape == (12, 12, 3) and st2["partition"] == {"tile": 2, "spp": 1}
img3, _ = preview.render_progressive(
    scene, cam, RenderConfig(width=12, height=12, samples_per_pixel=2))
assert img3.shape == (12, 12, 3)
assert native.library_path().name.startswith("host-")
# The demos' atlas scene, on the committed JPEG sample.
texels, _ = train_demo.atlas_image()
atlas = train_demo.atlas_scene(train_demo.box_down(texels, 16, 16), "cpu")
n_texels = (texels.shape[0] // 16) * (texels.shape[1] // 16)
assert tuple(atlas.atlas.shape) == (n_texels, 3), atlas.atlas.shape
# The entry points of the JAX repo's scripts: a bench_extra row and its
# trace at a tiny size on the CPU.
rec, _ = bench_extra.measure(bench_extra.setup("cornell", "cpu",
                                               size=(12, 12, 1, 3)))
assert rec["segments"] > 0 and rec["backend"] == "cpu", rec
s = trace_scene.trace("sphere_ground", "cpu", size=(12, 12, 1, 3))
assert s["top"], s
assert scaling_harness.sizes(3) == [1, 2, 3]
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
