"""Recorded benchmark of every BASELINE.md configuration (the counterpart of
the JAX package's ``scripts/bench_extra.py``: the same fifteen rows, sizes,
modes and runners).

    python -m another_raytracer_tpu_torch.bench_extra [name ...] [--obj PATH]
        [--out PATH] [--cpu]

Runs on the card unless ``--cpu`` is given (the kernels' plain versions on
the CPU), and raises when no CUDA device is visible.  Prints one JSON line
a row: the JAX script's keys (``scene``, ``config``, ``ms``,
``mrays_per_s``, ``segments``, ``compile_s``, ``backend``, the adaptive and
gradient extras, and on the card ``device_ms`` and ``device_mrays_per_s``)
and its own: ``device_reps`` (the profiled calls), ``card`` (the card's
name and power limit, ``utils.profiling.card_line``), ``kernels`` (every
kernel's launches over one call, ``ops.kernels.launch_counts``: the route
the row took), ``peak_mem_mb`` (``torch.cuda.max_memory_allocated``) and,
on mesh rows, ``mesh`` (the .obj's stem and its triangles).  A row whose input is
absent (the capsule or cow asset under ``ARTPU_ASSETS``, no ``--obj``)
prints the JAX script's ``skip`` line.  ``--obj`` replaces the capsule of
the rows built on ``library.mesh_scene``; ``mesh_hd`` always takes the
cow.  Writes no file unless ``--out`` names one (records merged into it by
row, as the JAX script merges into its ``BENCH_EXTRA.json``, which is the
JAX package's record and not written here).

Each runner makes one untimed first call (``compile_s``: the first call,
kernel builds included), then times ``REPS`` calls on the host clock, the
card synchronised at both ends (``ms``).  ``device_ms`` is the device's busy
time per call over ``PROFILED_REPS`` more calls (``device_reps``; one where
a call takes over ``PROFILE_SECONDS``), from a trace of the card's activity
(``utils.profiling``).  The calls, each at samples_per_pass 1 and t_min
1e-3, seed 0:

  * ``single``: ``render.render_radiance`` (the radiance sums, no image);
  * ``adaptive``: ``render.render`` in adaptive mode (the uint8 image);
  * ``grad``: ``diff.render_loss`` over ``DEFAULT_TRAINABLE`` plus the
    triangle vertices against a zero target, and ``.backward()``; its
    segments come from an untimed differentiable render, as in JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import kernels
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.utils import assets, imageio, profiling

REPS, PROFILED_REPS = 3, 3
# A row whose call takes longer is profiled once: a trace of a few seconds
# of the wavefront holds millions of events.
PROFILE_SECONDS = 5.0
SEED, T_MIN = 0, 1e-3
GRAD_TRAINABLE = diff.DEFAULT_TRAINABLE + ("tri_v0", "tri_v1", "tri_v2")


def metal_diel_scene(device="cuda"):
    """Four-sphere metal / dielectric / lambertian sweep scene, the fused
    differentiable path's widened class (material.h:45-99 parameters)."""
    b = SceneBuilder(background=(0.70, 0.80, 1.00), seed=2)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.8, 0.8, 0.0)))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.sphere((1, 0, -1), 0.5, b.metal(color=(0.8, 0.6, 0.2), fuzz=0.4))
    return (b.build(device=device),
            dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90))


def sphere_ground_scene(device="cuda"):
    """BASELINE config 1: one lambertian sphere and a ground sphere."""
    b = SceneBuilder(background=library.SKY)
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.5, 0.5, 0.5)))
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.5, 0.5, 0.5)))
    return (b.build(device=device),
            library._cam((0, 0, 0), (0, 0, -1), 90.0, aperture=0.0))


def textures_scene(device="cuda"):
    """BASELINE config 3: checker, Perlin, the earthmap image (solid cyan
    where the asset is absent) and a motion-blurred sphere."""
    b = SceneBuilder(background=library.SKY)
    checker = b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000, b.lambertian(texture=checker))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(texture=b.noise_texture(4.0)))
    path = assets.earthmap_path()
    img = imageio.load_image(path) if path else None
    b.sphere((0, 1, 0), 1.0, b.lambertian(texture=b.image_texture(img)))
    b.moving_sphere((4, 1, 0), (4, 1.3, 0), 0, 1, 1.0,
                    b.lambertian(color=(0.7, 0.3, 0.1)))
    return (b.build(device=device),
            library._cam((13, 2, 3), (0, 0, 0), 20.0, aperture=0.0))


def _cow_scene(device="cuda"):
    path = assets.cow_obj_path()
    if path is None:
        raise FileNotFoundError("cow.obj not available")
    return library.mesh_scene(obj_path=path, device=device)


# name -> (scene factory, W, H, spp, depth, mode): the JAX script's rows.
CONFIGS = {
    "sphere_ground": (sphere_ground_scene, 400, 225, 64, 8, "single"),
    "random": (library.random_scene, 400, 225, 8, 8, "single"),
    "textures": (textures_scene, 400, 225, 16, 8, "single"),
    "cornell": (library.cornell_box, 360, 270, 16, 8, "single"),
    "mesh": (library.mesh_scene, 720, 540, 16, 8, "single"),
    "final": (library.final_scene, 240, 180, 8, 8, "single"),
    "mesh_hd": (_cow_scene, 1920, 1080, 16, 8, "adaptive"),
    "mesh_grad": (library.mesh_scene, 240, 180, 4, 6, "grad"),
    "sphere_ground_grad": (sphere_ground_scene, 400, 225, 16, 8, "grad"),
    "metal_diel_grad": (metal_diel_scene, 400, 225, 16, 8, "grad"),
    "mesh_grad_bench": (library.mesh_scene, 720, 540, 16, 8, "grad"),
    "random_grad": (library.random_scene, 400, 225, 8, 8, "grad"),
    "final_grad_bench": (library.final_scene, 240, 180, 8, 8, "grad"),
    "textures_grad": (textures_scene, 400, 225, 16, 8, "grad"),
    "reference_default": (library.mesh_scene, 720, 540, 100, 50, "adaptive"),
}
MESH_FACTORIES = (library.mesh_scene, _cow_scene)


@dataclasses.dataclass
class Workload:
    """One row, set up on its device: ``size`` is (W, H, spp, depth);
    ``mesh`` the .obj's stem and triangles on mesh rows."""

    name: str
    mode: str
    size: tuple
    scene: object
    cam: object
    mesh: dict = None

    @property
    def config(self) -> str:
        w, h, spp, depth = self.size
        return f"{w}x{h} spp{spp} depth{depth} {self.mode}"


def setup(name, device, obj_path=None, size=None) -> Workload:
    """Build row ``name``'s scene and camera on ``device``; ``obj_path``
    replaces the capsule of the mesh-scene rows, ``size`` (W, H, spp,
    depth) the row's.  Raises FileNotFoundError where its input is
    absent."""
    factory, w, h, spp, depth, mode = CONFIGS[name]
    if size is not None:
        w, h, spp, depth = size
    dev = torch.device(device)
    if factory is library.mesh_scene:
        scene, cam_params = factory(obj_path=obj_path, device=dev)
        obj_path = obj_path or assets.capsule_obj_path()
    else:
        scene, cam_params = factory(device=dev)
    if factory is _cow_scene:
        obj_path = assets.cow_obj_path()
    mesh = None
    if factory in MESH_FACTORIES:
        mesh = {"obj": Path(obj_path).stem,
                "triangles": int(scene.tri_v0.shape[0])}
    cam = camera_lib.make_camera(aspect_ratio=w / h, device=dev, **cam_params)
    return Workload(name, mode, (w, h, spp, depth), scene, cam, mesh)


def _kw(size):
    w, h, spp, depth = size
    return dict(width=w, height=h, spp=spp, samples_per_pass=1,
                max_depth=depth, t_min=T_MIN)


def forward_call(wl: Workload) -> Callable:
    """One forward render: () -> (radiance sums V3 of [H*W], segments)."""
    def call():
        with torch.no_grad():
            return render_lib.render_radiance(wl.scene, wl.cam, SEED,
                                              **_kw(wl.size))
    return call


def adaptive_call(wl: Workload) -> Callable:
    """One adaptive render: () -> (uint8 image [H, W, 3], stats)."""
    w, h, spp, depth = wl.size
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       max_depth=depth, seed=SEED, t_min=T_MIN,
                       mode=RenderMode.ADAPTIVE)
    return lambda: render_lib.render(wl.scene, wl.cam, cfg)


def grad_call(wl: Workload) -> Callable:
    """One fwd+bwd step: () -> (loss, {leaf: gradient}); a leaf the loss
    does not reach gets zeros, as in JAX."""
    w, h = wl.size[:2]
    params, _ = diff.split_params(wl.scene, GRAD_TRAINABLE)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    target = torch.zeros((w * h, 3), dtype=torch.float32,
                         device=wl.scene.device)

    def call():
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss = diff.render_loss(params, wl.scene, wl.cam, target, SEED,
                                    **_kw(wl.size))
            loss.backward()
        return loss.detach(), {k: torch.zeros_like(p) if p.grad is None
                               else p.grad for k, p in params.items()}
    return call


CALLS = {"single": forward_call, "adaptive": adaptive_call, "grad": grad_call}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(before, after) -> dict:
    """Every kernel's launches between two ``launch_counts``, K5's by tree
    and table route where it launched."""
    out = {k: after[k] - before[k] for k in after if k != "K5_by_tree"}
    trees = {t: n - before["K5_by_tree"].get(t, 0)
             for t, n in after["K5_by_tree"].items()}
    out["K5_by_tree"] = {t: n for t, n in trees.items() if n}
    return out


@dataclasses.dataclass
class Run:
    """A runner's measurements: ``seconds`` a call (mean of ``reps``), the
    first call's seconds, the launches over it, the device's busy ms a
    call over ``device_reps`` profiled calls (None off the card) and the
    last call's output."""

    seconds: float
    first_s: float
    launches: dict
    device_ms: float
    device_reps: int
    out: object


def timed(call, dev, reps=REPS, profiled_reps=PROFILED_REPS) -> Run:
    """The runners' protocol around ``call``."""
    before = kernels.launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    out = call()
    _sync(dev)
    first_s = time.perf_counter() - t0
    launches = _launches(before, kernels.launch_counts())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = call()
    _sync(dev)
    seconds = (time.perf_counter() - t0) / reps
    device_ms, device_reps = None, 0
    if dev.type == "cuda":
        device_reps = profiled_reps if seconds <= PROFILE_SECONDS else 1
        with tempfile.TemporaryDirectory() as log_dir:
            with profiling.trace(log_dir, host=False):
                for _ in range(device_reps):
                    call()
            device_ms = (profiling.device_seconds(log_dir) * 1e3
                         / device_reps)
    return Run(seconds, first_s, launches, device_ms, device_reps, out)


def run_forward(wl: Workload, **protocol):
    """-> (Run, segments, extra); ``protocol``: ``timed``'s reps."""
    run = timed(forward_call(wl), wl.scene.device, **protocol)
    return run, int(run.out[1]), {}


def run_adaptive(wl: Workload, **protocol):
    run = timed(adaptive_call(wl), wl.scene.device, **protocol)
    stats = run.out[1]
    return run, stats["segments"], {
        "traced_pixels": stats["traced_pixels"],
        "total_pixels": stats["total_pixels"]}


def run_grad(wl: Workload, **protocol):
    # Honest segment count from an (untimed) differentiable render.
    with torch.no_grad():
        _, segments = render_lib.render_radiance(
            wl.scene, wl.cam, SEED, differentiable=True, **_kw(wl.size))
    segments = int(segments)
    run = timed(grad_call(wl), wl.scene.device, **protocol)
    _, grads = run.out
    gnorm = float(sum(float((g.double() ** 2).sum())
                      for g in grads.values()) ** 0.5)
    if not (math.isfinite(gnorm) and gnorm > 0.0):
        raise AssertionError(f"{wl.name}: gradient norm {gnorm}")
    return run, segments, {"fwd_bwd": True, "grad_leaves": len(grads),
                           "grad_norm": gnorm}


RUNNERS = {"single": run_forward, "adaptive": run_adaptive, "grad": run_grad}


def measure(wl: Workload, **protocol):
    """Run ``wl`` through its runner (``protocol``: ``timed``'s reps) ->
    (its record, the Run)."""
    dev = wl.scene.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run, segments, extra = RUNNERS[wl.mode](wl, **protocol)
    rec = {"scene": wl.name, "config": wl.config,
           "ms": run.seconds * 1e3,
           "mrays_per_s": segments / run.seconds / 1e6,
           "segments": segments, "compile_s": run.first_s,
           "backend": dev.type, **extra}
    if run.device_ms is not None:
        rec["device_ms"] = run.device_ms
        rec["device_mrays_per_s"] = segments / run.device_ms / 1e3
        rec["device_reps"] = run.device_reps
    rec["card"] = profiling.card_line() if dev.type == "cuda" else None
    rec["kernels"] = run.launches
    rec["peak_mem_mb"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                          if dev.type == "cuda" else None)
    if wl.mesh is not None:
        rec["mesh"] = wl.mesh
    return rec, run


def report(wl: Workload) -> dict:
    """Measure ``wl`` and print its record."""
    rec, _ = measure(wl)
    print(json.dumps(rec), flush=True)
    return rec


def run_one(name, device, obj_path=None, size=None) -> dict:
    """Measure row ``name`` on ``device`` and print its record."""
    return report(setup(name, device, obj_path, size))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("names", nargs="*", metavar="name",
                   help=f"rows to run (default all): {', '.join(CONFIGS)}")
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="the .obj of the mesh-scene rows (default the "
                        "capsule asset)")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="merge the records into this JSON file")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    unknown = [n for n in args.names if n not in CONFIGS]
    if unknown:
        p.error(f"unknown rows {unknown}; known: {', '.join(CONFIGS)}")
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (use --cpu for the "
                           "plain PyTorch versions on the CPU)")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    records = {}
    if args.out and Path(args.out).exists():
        records = {r["scene"]: r for r in json.loads(
            Path(args.out).read_text())}
    for name in args.names or list(CONFIGS):
        try:
            wl = setup(name, device, args.obj)
        except FileNotFoundError as e:
            print(f"skip {name}: {e}", flush=True)
            continue
        records[name] = report(wl)
    if args.out:
        Path(args.out).write_text(
            json.dumps(list(records.values()), indent=1) + "\n")
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
