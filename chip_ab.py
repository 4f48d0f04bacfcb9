#!/usr/bin/env python3
"""A/B of the megakernel's accel mode (K3) between two checkouts on one GPU.

    python3 chip_ab.py OTHER_CHECKOUT [--runs 5]

Runs a worker process for each side in turns: OTHER_CHECKOUT, this
checkout, this checkout, OTHER_CHECKOUT.  Each worker imports the
``another_raytracer_tpu_torch`` package of its own checkout (which builds its
kernels into that checkout's ``_build/``), and times on the scene-1 README
render's inputs:

* ``k3_ms``: K3's forward instance alone (bare launch) on 720x540, spp 100,
  depth 50, Morton-ordered lanes (as ``render`` traces them);
* ``k3_record_ms``: K3's record instance alone at the bench size (360x270,
  spp 16, depth 8);
* ``adaptive_ms`` and ``single_ms``: ``render.render`` of scene 1 at the
  README size in adaptive and in single mode (host clock around a render
  that ends in the copy to the host);

each the median of ``--runs`` after a warm-up (kernels: CUDA events after a
synchronise).  Prints one JSON line per worker, then the card's name and
power limit and a JSON summary (median over each side's turns).  Exits non-zero without a result when no CUDA device is
visible.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

W, H, SPP, DEPTH = 720, 540, 100, 50  # the README render, scene 1
BW, BH, BSPP, BDEPTH = 360, 270, 16, 8  # the bench size


def cuda_ms(fn, runs):
    import torch

    fn()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def host_ms(fn, runs):
    fn()
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return float(np.median(out))


def measure(runs):
    """The side's timings."""
    import torch

    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    dev = torch.device("cuda", 0)
    scene, cp = library.random_scene(device=dev)

    def bare(run):
        def go():
            if run() != 0:
                raise RuntimeError("launch failed")
        return go

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cp)
    order, _ = render_lib.morton_order(W, H)
    pix = torch.from_numpy(order.astype(np.int64)).to(dev)
    samp = torch.zeros_like(pix)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    run, (_, seg) = mega_kernel.prepare_launch(scene, cam, pix, samp, 0, **kw)
    res = dict(k3_ms=cuda_ms(bare(run), runs))
    res["k3_segments"] = int(seg.sum())

    bcam = camera_lib.make_camera(aspect_ratio=BW / BH, device=dev, **cp)
    bpix = torch.arange(BW * BH, dtype=torch.int64, device=dev)
    run, _ = mega_kernel.prepare_launch(
        scene, bcam, bpix, torch.zeros_like(bpix), 0, width=BW, height=BH,
        sample_stride=1, sample_end=BSPP, spp_cap=BSPP, max_depth=BDEPTH,
        t_min=1e-3, record_iters=BSPP * BDEPTH)
    res["k3_record_ms"] = cuda_ms(bare(run), runs)

    for mode in ("adaptive", "single"):
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                           max_depth=DEPTH, mode=RenderMode(mode))
        res[f"{mode}_ms"] = host_ms(
            lambda: render_lib.render(scene, cam, cfg), runs)
    return res


def run_side(checkout, runs):
    """One worker: this file run with ``--worker`` in ``checkout``."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", checkout,
           "--runs", str(runs)]
    res = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True,
                         timeout=1800)
    if res.returncode != 0:
        raise SystemExit(f"worker on {checkout} failed:\n{res.stdout}\n"
                         f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the checkout to compare with")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        # This file lives in one checkout; import the package of the other.
        sys.path[0] = os.path.abspath(args.worker)
        print(json.dumps(measure(args.runs)))
        return 0
    if args.other is None:
        ap.error("name the checkout to compare with")
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is visible; this check needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    turns = [("other", other), ("this", here), ("this", here),
             ("other", other)]
    results = {"other": [], "this": []}
    for side, path in turns:
        r = run_side(path, args.runs)
        results[side].append(r)
        print(json.dumps({"side": side, "checkout": path, **r}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
    summary = {side: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
               for side, rs in results.items()}
    summary["this_over_other"] = {
        k: summary["this"][k] / summary["other"][k]
        for k in summary["this"] if k.endswith("_ms")}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
