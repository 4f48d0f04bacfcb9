"""Benchmark: forward + backward Mrays/s on the Cornell box (the workload and
protocol of the JAX package's ``bench.py``).

    python -m another_raytracer_tpu_torch.bench

Needs a CUDA device.  Prints ONE JSON line with the keys of ``bench.py``'s
(``metric``, ``value``, ``unit``, ``wall_ms``, ``device_ms``,
``device_mrays_per_s``).  There is no ``vs_baseline``: the repository's
baseline is a TPU number.

Ray counting is honest: traced segments including bounce rays, from an
untimed differentiable render under ``no_grad`` (the lockstep path, as in
``bench.py``).  The timed region is one full differentiable step —
``diff.render_value_and_grad`` over ``DEFAULT_TRAINABLE``, which on the
Cornell box runs the record-mode megakernel and the replay backward — with
2 warm-ups, then the mean of 20 steps on the host clock (``wall_ms``).
``device_ms`` is the device's busy time per step, the summed duration of
the device activity that ``torch.profiler`` records over 5 more steps (the
JAX bench takes it from a device trace too).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import render as render_lib

WIDTH, HEIGHT, SPP, MAX_DEPTH = 360, 270, 16, 8  # bench.py's workload
WARMUP, ITERS, PROFILED = 2, 20, 5


def _device_ms(step, n):
    """Device busy ms per call of ``step``, from a profiler trace of n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device activity")
    return us / 1e3 / n


def run(device) -> dict:
    """Run the benchmark on ``device`` and return its JSON record (device
    time only on CUDA; a CPU run uses the kernels' plain versions)."""
    dev = torch.device(device)
    kw = dict(width=WIDTH, height=HEIGHT, spp=SPP, samples_per_pass=1,
              max_depth=MAX_DEPTH, t_min=1e-3)

    scene, cam_params = library.cornell_box(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=WIDTH / HEIGHT, device=dev,
                                 **cam_params)
    params, _ = diff.split_params(scene)
    target = torch.zeros((WIDTH * HEIGHT, 3), dtype=torch.float32, device=dev)

    # Honest segment count from an (untimed) forward render.
    with torch.no_grad():
        _, segments = render_lib.render_radiance(scene, cam, 0,
                                                 differentiable=True, **kw)
    segments = int(segments)

    def step():
        return diff.render_value_and_grad(params, scene, cam, target, 0, **kw)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        step()
    sync()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step()
    sync()
    dt = (time.perf_counter() - t0) / ITERS

    rec = {
        "metric": "cornell_box_fwd_bwd",
        "value": round(segments / dt / 1e6, 3),
        "unit": "Mrays/s/chip",
        "wall_ms": round(dt * 1e3, 3),
    }
    if dev.type == "cuda":
        device_ms = _device_ms(step, PROFILED)
        rec["device_ms"] = round(device_ms, 3)
        rec["device_mrays_per_s"] = round(segments / device_ms / 1e3, 1)
        rec["device"] = torch.cuda.get_device_name(dev)
    rec["segments"] = segments
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device is visible", file=sys.stderr)
        return 1
    print(json.dumps(run("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
