#!/usr/bin/env python3
"""A/B of the kernels between two checkouts on one GPU: the megakernel
(K1, K2, K3 and the replay) and the wavefront's two (K5 and K4).

    python3 chip_ab.py OTHER_CHECKOUT [--runs 5]
                       [--only megakernel|wavefront|replay|bench]

Runs a worker process for each side in turns: OTHER_CHECKOUT, this
checkout, this checkout, OTHER_CHECKOUT.  Each worker imports the
``another_raytracer_tpu_torch`` package of its own checkout (which builds its
kernels into that checkout's ``_build/``) and times, with that package's
defaults (block size, lane mapping):

* ``k1_ms``: K1 alone (bare launch) on the Cornell README render's inputs
  (720x540, spp 100, depth 50);
* ``k2_ms``: K2 alone at the bench size (Cornell 360x270, spp 16, depth 8);
* ``replay_ms`` and ``replay_large_ms``: the replay alone on K2's residuals
  (Cornell, 4 textures) and on K3's record instance's at the same size on
  scene 1 (485 textures), a cotangent of 0.5 per channel, by
  ``chip_smoke.graph_ms``; ``replay_backward_ms`` and
  ``replay_large_backward_ms``: the backward as the fused step runs it
  (``mega_diff.replay_backward``: the wrapper's device work, the launch and
  the sum of its partial rows), by ``graph_ms`` too; where the side's
  wrapper takes the scene's tex_cb row map (``mega_diff.ReplaySlots``), the
  launch on each instance (``_columns``, ``_tables``) at each block of
  ``REPLAY_BLOCKS``, and ``replay_t{T}_*``: the same on scene 1's record
  with its texture ids folded onto the first T textures, for each T of
  ``MID_T`` (``replay_t{T}_pick_ms``: the block ``replay_instance`` picks);
* with ``--only replay``, ``step_ms`` and ``step_large_ms``: one fused
  fwd+bwd step at the bench size on Cornell and on scene 1, each built
  afresh (nothing packed on it before the warm-up step, as ``bench.py``
  runs it), and ``bench_wall_ms`` / ``bench_device_ms``: the side's
  ``another_raytracer_tpu_torch.bench`` record (the mean of 20 steps on
  the host clock, and the profiler's device time per step), which
  ``--only bench`` times alone;
* ``cornell_single_ms``: ``render.render`` of the Cornell README render in
  single mode (host clock around a render that ends in the copy to the
  host);
* ``step_ms``: one fused fwd+bwd step at the bench size
  (``diff.render_value_and_grad`` of the shading parameters, CUDA events);
* ``k3_ms``: K3's forward instance alone on the scene-1 README render,
  Morton-ordered lanes (as ``render`` traces them);
* ``k3_record_ms``: K3's record instance alone at the bench size;
* ``adaptive_ms`` and ``single_ms``: ``render.render`` of scene 1 at the
  README size in adaptive and in single mode;
* ``k5_*_ms``: K5 alone with the wavefront's variant of each tree kind on
  scene 1's first call (388,800 camera rays, sphere fold) and on the three
  cases of ``chip_smoke.k5_cases`` (the planar one with and without the
  precomputed geometry), and ``k4_ms`` / ``k4_width_ms``: K4 alone on
  388,800 points of scene 3's table set and on the main path's mean width
  (``K4_WIDTH``); these kernels take microseconds to milliseconds, so each
  is ``chip_smoke.graph_ms``'s device time per launch (launches captured in
  a CUDA graph, without the host's submission);

each the median of ``--runs`` after a warm-up (kernels: CUDA events after a
synchronise), with the segments of K1 and K3's launches, and the registers
and static instruction census (``chip_smoke.sass_census`` of this
checkout) of every megakernel instance the side built, and K5's registers
per instance.  ``--only`` times one group: the megakernel, the wavefront,
or the replay alone (K2 and K3's record instance write its residuals).  Prints one JSON
line per worker, then the card's name and power limit and a JSON summary
(median over each side's turns of the numbers).  Exits non-zero without a
result when no CUDA device is visible.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

W, H, SPP, DEPTH = 720, 540, 100, 50  # the README render (Cornell, scene 1)
BW, BH, BSPP, BDEPTH = 360, 270, 16, 8  # the bench size
# K4's mean points per launch in the scene-3 and scene-5 renders at 720x540,
# spp 16, depth 50 (chip_smoke.py's main_path_textures; the same on both
# sides, since the wavefront does not depend on the kernel).
K4_WIDTH = 42052
REPLAY_BLOCKS = (32, 64, 128, 256)  # the replay's blocks per instance
# Texture counts between the main paths' 4 and 485, where replay_instance
# picks by size alone.
MID_T = (32, 64, 128, 256)


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


def measure(runs, only=None):
    """The side's timings (``only``: "megakernel", "wavefront", "replay"
    or "bench")."""
    import torch

    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.ops.kernels import mega_diff, mega_kernel
    from another_raytracer_tpu_torch.ops.vec3 import V3

    dev = torch.device("cuda", 0)

    def bare(run):
        def go():
            if run() != 0:
                raise RuntimeError("launch failed")
        return go

    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    bkw = dict(width=BW, height=BH, sample_stride=1, sample_end=BSPP,
               spp_cap=BSPP, max_depth=BDEPTH, t_min=1e-3)
    bpix = torch.arange(BW * BH, dtype=torch.int64, device=dev)
    res = {}
    if only in (None, "wavefront"):
        measure_wavefront(runs, dev, res)
    if only == "wavefront":
        return res

    smoke = this_smoke()

    def replay(scene, bcam, key):
        """The replay on the record instance's own residuals (module
        docstring) into ``res``."""
        _, _, codes, tprev = mega_kernel.trace_regenerative_mega(
            scene, bcam, bpix, torch.zeros_like(bpix), 0,
            record_iters=BSPP * BDEPTH, **bkw)
        ghat = V3(*(torch.full((BW * BH,), 0.5, device=dev)
                    for _ in range(3)))
        args = (codes, tprev, ghat, scene.tex_ca, scene.tex_cb,
                scene.background, mega_diff._flags(scene))
        new = hasattr(mega_diff, "ReplaySlots")
        if new:
            args += (scene.replay_slots(),)

        def time(args=args, launches=100, **kw):
            return smoke.graph_ms(lambda: mega_diff.prepare_replay(
                *args, **kw)[0], dev, launches, runs)[0]

        def backward():
            mega_diff.replay_backward(*args)
            return 0

        res[f"{key}_ms"] = time()
        res[f"{key}_backward_ms"] = smoke.graph_ms(lambda: backward, dev, 20,
                                                   runs)[0]
        if not new:
            return
        T, C = scene.tex_ca.shape[0], scene.replay_slots().checkers
        for k, v in mega_diff.replay_work(codes, T, C).items():
            res[f"{key}_{k}"] = v
        shapes(args, key, time)
        if key != "replay_large":
            return
        tid = codes >> 4
        for t in MID_T:
            # Ids folded onto textures 0 .. t - 1, the sentinel onto t.
            fold = (torch.where(tid >= T, t, tid % t) << 4) | (codes & 15)
            shapes((fold, tprev, ghat, scene.tex_ca[:t], scene.tex_cb[:t],
                    scene.background, args[6],
                    mega_diff.pack_replay_slots(scene.tex_kind[:t])),
                   f"replay_t{t}", time)

    def shapes(args, key, time):
        """The launch on ``args`` on each instance and block that fits,
        and at ``replay_instance``'s pick, into ``res``."""
        T, C = args[3].shape[0], args[7].checkers
        for inst, name in ((mega_diff.LANE_COLUMNS, "columns"),
                           (mega_diff.WARP_TABLES, "tables")):
            for blk in REPLAY_BLOCKS:
                if mega_diff.replay_smem_bytes(T, C, blk, inst) <= 232448:
                    res[f"{key}_{name}_{blk}_ms"] = time(
                        args, instance=inst, block=blk)
        res[f"{key}_pick_ms"] = time(args)
        res[f"{key}_pick"] = "%s %d" % (
            ("columns", "tables")[mega_diff.replay_instance(T, C)[0]],
            mega_diff.replay_instance(T, C)[1])

    def step(scene, bcam):
        """One fused fwd+bwd step at the bench size (CUDA events)."""
        params, _ = diff.split_params(scene)
        target = torch.zeros((BW * BH, 3), device=dev)
        return cuda_ms(lambda: diff.render_value_and_grad(
            params, scene, bcam, target, 0, width=BW, height=BH, spp=BSPP,
            samples_per_pass=1, max_depth=BDEPTH, t_min=1e-3), runs)

    if only in ("replay", "bench"):
        from another_raytracer_tpu_torch import bench

        rec = bench.run("cuda")
        res["bench_wall_ms"], res["bench_device_ms"] = (rec["wall_ms"],
                                                        rec["device_ms"])
    if only == "bench":
        return res
    if only == "replay":
        for build, tag in ((library.cornell_box, ""),
                           (library.random_scene, "_large")):
            scene, cp = build(device=dev)
            bcam = camera_lib.make_camera(aspect_ratio=BW / BH, device=dev,
                                          **cp)
            res[f"step{tag}_ms"] = step(scene, bcam)
            replay(scene, bcam, f"replay{tag}")
        return res

    # The Cornell box: K1, K2, its render and its training step.
    cornell, cp = library.cornell_box(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cp)
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    run, (_, seg) = mega_kernel.prepare_launch(cornell, cam, pix,
                                               torch.zeros_like(pix), 0, **kw)
    res["k1_ms"] = cuda_ms(bare(run), runs)
    res["k1_segments"] = int(seg.sum())
    bcam = camera_lib.make_camera(aspect_ratio=BW / BH, device=dev, **cp)
    run, _ = mega_kernel.prepare_launch(
        cornell, bcam, bpix, torch.zeros_like(bpix), 0,
        record_iters=BSPP * BDEPTH, **bkw)
    res["k2_ms"] = cuda_ms(bare(run), runs)
    replay(cornell, bcam, "replay")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, mode=RenderMode("single"))
    res["cornell_single_ms"] = host_ms(
        lambda: render_lib.render(cornell, cam, cfg), runs)
    res["step_ms"] = step(cornell, bcam)

    # Scene 1: K3, its record instance and its renders.
    scene, cp = library.random_scene(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cp)
    order, _ = render_lib.morton_order(W, H)
    pix = torch.from_numpy(order.astype(np.int64)).to(dev)
    run, (_, seg) = mega_kernel.prepare_launch(scene, cam, pix,
                                               torch.zeros_like(pix), 0, **kw)
    res["k3_ms"] = cuda_ms(bare(run), runs)
    res["k3_segments"] = int(seg.sum())
    bcam = camera_lib.make_camera(aspect_ratio=BW / BH, device=dev, **cp)
    run, _ = mega_kernel.prepare_launch(
        scene, bcam, bpix, torch.zeros_like(bpix), 0,
        record_iters=BSPP * BDEPTH, **bkw)
    res["k3_record_ms"] = cuda_ms(bare(run), runs)
    replay(scene, bcam, "replay_large")
    for mode in ("adaptive", "single"):
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                           max_depth=DEPTH, mode=RenderMode(mode))
        res[f"{mode}_ms"] = host_ms(
            lambda: render_lib.render(scene, cam, cfg), runs)
    res["census"] = census()
    return res


def measure_wavefront(runs, dev, res):
    """K5 and K4 alone (module docstring) into ``res``."""
    import torch

    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops.kernels import (_build, bvh_kernel,
                                                         perlin_kernel)
    from another_raytracer_tpu_torch.ops.vec3 import V3

    smoke = this_smoke()
    scene1, cam1 = library.random_scene(device=dev)
    cases = [smoke.k5_first_call(dev, scene1, cam1)]
    cases += smoke.k5_cases(dev, scene1, cam1)
    for case, key in zip(cases, ("first_call", "spheres", "triangles",
                                 "rects")):
        prim = case[7]
        fold, full, pre = smoke.k5_main(
            prim, scene1 if prim == "sphere" else None)
        args, kw = smoke.k5_args(case, dev)
        for p, tag in ((pre, ""), (False, "_no_precomp")):
            if tag and prim != "planar":
                continue
            # The side's packed tables where it has them (packed here, in
            # the capture, where not).
            extra = ({"tables": bvh_kernel.pack_tables(args[0], args[1], prim,
                                                       p)}
                     if hasattr(bvh_kernel, "pack_tables") else {})
            res[f"k5_{key}{tag}_ms"] = smoke.graph_ms(
                lambda: bvh_kernel.prepare_launch(
                    *args, t_min=1e-3, fold_record=fold, fold_full=full,
                    precomp=p, **kw, **extra)[0], dev, 20, runs)[0]
    res["k5_registers"] = [int(r) for r in re.findall(
        r"Used (\d+) registers", _build.build_log("bvh_kernel"))]
    scene3, _ = library.two_perlin_spheres(device=dev)
    g = np.random.default_rng(2)
    n = W * H
    pv = V3(*(torch.from_numpy(g.uniform(-20, 20, n).astype(np.float32)).to(dev)
              for _ in range(3)))
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    res["k4_ms"] = smoke.graph_ms(
        lambda: perlin_kernel.prepare_launch(scene3, ids, pv)[0], dev, 100,
        runs)[0]
    pw = V3(*(c[:K4_WIDTH] for c in pv))
    res["k4_width_ms"] = smoke.graph_ms(
        lambda: perlin_kernel.prepare_launch(scene3, ids[:K4_WIDTH], pw)[0],
        dev, 100, runs)[0]


def this_smoke():
    """This checkout's chip_smoke.py as a module (the worker's import path
    holds the other side's package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def census():
    """{build: {instance: counts}} of the side's built megakernel libraries:
    registers, spilled bytes and the SASS census, with this checkout's
    chip_smoke.py (the side's package builds and locates the libraries)."""
    from another_raytracer_tpu_torch.ops.kernels import _build

    smoke = this_smoke()
    out = {}
    for build in ("mega_kernel", "mega_kernel_record"):
        path, _ = _build.build(build)
        log = _build.build_log(build)
        out[build] = {}
        for walk, counts in smoke.sass_census(path).items():
            tag = [t for t, w in smoke.WALK_NAMES.items() if w == walk][0]
            regs, spilled = smoke.kernel_usage(
                log, f"mega_forward_kernelILi{tag}EE")
            out[build][walk] = dict(counts, registers=regs, spilled=spilled)
    return out


def run_side(checkout, runs, only=None):
    """One worker: this file run with ``--worker`` in ``checkout``."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", checkout,
           "--runs", str(runs)] + (["--only", only] if only else [])
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
    ap.add_argument("--only", choices=("megakernel", "wavefront", "replay",
                                       "bench"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        # This file lives in one checkout; import the package of the other.
        sys.path[0] = os.path.abspath(args.worker)
        print(json.dumps(measure(args.runs, args.only)))
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
        r = run_side(path, args.runs, args.only)
        results[side].append(r)
        print(json.dumps({"side": side, "checkout": path, **r}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
    summary = {side: {k: float(np.median([r[k] for r in rs])) for k in rs[0]
                      if isinstance(rs[0][k], (int, float))}
               for side, rs in results.items()}
    summary["this_over_other"] = {
        k: summary["this"][k] / summary["other"][k]
        for k in summary["this"] if k.endswith("_ms") and k in summary["other"]}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
