#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward megakernel from ``another_raytracer_tpu_torch/csrc``,
checks its threefry words bit for bit against the port's PyTorch threefry,
holds the kernel against its plain PyTorch version on three scenes, renders
the Cornell box at the README size (720x540, spp 100, depth 50) through the
port's CLI, and times the kernel and the plain version at that size.  Every
phase prints one line and any failure raises (non-zero exit).  The last
three lines are the card's name and power limit (nvidia-smi), a JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible or the port
package is not beside this script.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# The bar of tests/test_mega.py:37-45 (kernel vs reference).
FLIP_ABS, FLIP_BUDGET, MEDIAN_MAX = 2e-2, 0.02, 1e-5

W, H, SPP, DEPTH = 720, 540, 100, 50
REPLACES = "another_raytracer_tpu/ops/pallas/mega_kernel.py:224"
SOURCE = "another_raytracer_tpu_torch/csrc/mega_kernel.cu"


def phase(name, line):
    print(f"[{name}] {line}", flush=True)


def metal_scene(device):
    """Lens + motion + metal + dielectric + checker (tests/test_mega.py:53-66)."""
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(device=device), cam


def lanes(width, height, device):
    import torch

    n = width * height
    return (torch.arange(n, dtype=torch.int64, device=device),
            torch.zeros(n, dtype=torch.int64, device=device))


def compare(scene, cam_params, width, height, spp, depth, device, seed=3):
    """Kernel vs plain version on the same lanes; raises unless within bar."""
    import torch

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import vec3
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    cam = camera_lib.make_camera(aspect_ratio=width / height, device=device,
                                 **cam_params)
    pix, samp = lanes(width, height, device)
    kw = dict(width=width, height=height, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=depth, t_min=1e-3)
    got, got_segs = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp, seed, **kw)
    ref, ref_segs = mega_kernel.trace_regenerative_mega_reference(
        scene, cam, pix, samp, seed, **kw)
    torch.cuda.synchronize(device)
    got, ref = vec3.to_numpy(got), vec3.to_numpy(ref)
    got_segs, ref_segs = int(got_segs), int(ref_segs)
    if not np.isfinite(got).all():
        raise AssertionError("kernel radiance has non-finite values")
    diff = np.abs(got - ref)
    stats = dict(segments=got_segs, segments_plain=ref_segs,
                 max_abs_err=float(diff.max()),
                 median_abs_err=float(np.median(diff)),
                 frac_over=float((diff > FLIP_ABS).mean()))
    if abs(got_segs - ref_segs) > max(4, 0.01 * ref_segs):
        raise AssertionError(f"segment drift too large: {stats}")
    if stats["frac_over"] > FLIP_BUDGET or stats["median_abs_err"] >= MEDIAN_MAX:
        raise AssertionError(f"radiance disagrees beyond the bar: {stats}")
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import rng
    from another_raytracer_tpu_torch.ops.kernels import _build, mega_kernel
    from another_raytracer_tpu_torch.utils import imageio

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build from the checkout's sources.
    path, secs = _build.build("mega_kernel")
    usage = [ln.strip() for ln in _build.build_log("mega_kernel").splitlines()
             if "registers" in ln or "spill" in ln]
    phase("build", f"{path.name} built in {secs:.1f} s; " + " | ".join(usage))

    # 2. Threefry words on the card: CUDA vs the port's torch threefry.
    n = 1 << 20
    g = torch.Generator(device="cpu").manual_seed(0)
    pixel = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    sample = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    checked = 0
    for seed, bounce, dim in [(7, 0, 0), (0xDEADBEEF, 3, 2),
                              (12345, rng.CAMERA_BOUNCE, rng.DIM_TIME)]:
        key1 = (bounce << 8) | dim
        (w0, w1), (u0, u1) = mega_kernel.threefry_words_cuda(seed, key1, pixel, sample)
        r0, r1 = rng.threefry2x32(seed, key1, pixel, sample, rounds=rng.ROUNDS)
        v0, v1 = rng.uniform2(seed, pixel, sample, bounce, dim)
        if not (torch.equal(w0, r0) and torch.equal(w1, r1)):
            raise AssertionError(f"threefry words differ (seed={seed}, key1={key1})")
        if not (torch.equal(u0.view(torch.int32), v0.view(torch.int32))
                and torch.equal(u1.view(torch.int32), v1.view(torch.int32))):
            raise AssertionError(f"uniform2 bits differ (seed={seed}, key1={key1})")
        checked += n
    phase("threefry", f"{checked} counters bit-exact (words and uniforms)")

    # 3. Kernel vs plain version on the card.
    cornell, cornell_cam = library.cornell_box(device=dev)
    results = {}
    for name, (scene, cam_params) in [
            ("cornell", (cornell, cornell_cam)),
            ("two_spheres", library.two_spheres(device=dev)),
            ("lens_motion_metal_dielectric_checker", metal_scene(dev))]:
        st = compare(scene, cam_params, W, H, 4, DEPTH, dev)
        results[name] = st
        phase("compare", f"{name} {W}x{H} spp4 depth{DEPTH}: {json.dumps(st)}")

    # 4. The main path: the CLI, exactly as a user runs it.
    mega_kernel.trace_regenerative_mega.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--scene", "6", "--width", str(W), "--height", str(H),
                           "--spp", str(SPP), "--max-depth", str(DEPTH),
                           "--mode", "single", "--device", "cuda", "--out", out])
        launches = mega_kernel.trace_regenerative_mega.launches
        cli_out = buf.getvalue()
        img = imageio.load_png(out)
    segs = int(re.search(r"(\d+) segments", cli_out).group(1))
    if rc != 0 or launches < 1 or segs <= 0:
        raise AssertionError(f"main path: rc={rc} launches={launches} "
                             f"segments={segs}\n{cli_out}")
    if img.shape != (H, W, 3) or img.mean() < 10.0:
        raise AssertionError(f"main path image is wrong: shape {img.shape}, "
                             f"mean {img.mean():.2f}")
    phase("main_path", f"{cli_out.strip().splitlines()[-2]}; kernel launches "
          f"{launches}; PNG {img.shape} mean {img.mean():.2f}")

    # 5. Timing at the main path's size: kernel (median of 5) vs plain (once).
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    pix, samp = lanes(W, H, dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        _, s = fn(cornell, cam, pix, samp, 0, **kw)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end), int(s)

    timed(mega_kernel.trace_regenerative_mega)  # warm-up
    runs = [timed(mega_kernel.trace_regenerative_mega) for _ in range(5)]
    ms = float(np.median([r[0] for r in runs]))
    segs_k = runs[0][1]
    plain_ms, segs_p = timed(mega_kernel.trace_regenerative_mega_reference)
    phase("timing", f"cornell {W}x{H} spp{SPP} depth{DEPTH}: kernel {ms:.3f} ms "
          f"(runs {[round(r[0], 3) for r in runs]}), {segs_k} segments, "
          f"{segs_k / ms / 1e3:.1f} Mrays/s; plain {plain_ms:.1f} ms, "
          f"{segs_p} segments, {segs_p / plain_ms / 1e3:.3f} Mrays/s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"kernels": [{
        "name": "mega_kernel (forward sweep megakernel, K1)",
        "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": results["cornell"]["max_abs_err"],
        "median_abs_err": results["cornell"]["median_abs_err"],
        "frac_lanes_over_2e-2": results["cornell"]["frac_over"],
        "ms": ms, "plain_ms": plain_ms,
        "segments": segs_k, "mrays_per_s": segs_k / ms / 1e3,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke finished in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
