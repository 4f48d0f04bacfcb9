"""Profiler trace of one ``bench_extra`` row, summarised by kernel category
and by op (the counterpart of the JAX package's ``scripts/trace_scene.py``
with ``trace_probe.summarize`` and ``summarize_ops``).

    python -m another_raytracer_tpu_torch.trace_scene NAME [--obj PATH]
        [--log-dir DIR] [--cpu]

Runs the row's call once to warm up (kernel builds, table packing), then
traces ``RUNS`` calls with ``torch.profiler`` (``utils.profiling.trace``):
the render of a forward or adaptive row, the fwd+bwd step of a gradient
row.  Prints the device time a run by category (the port's kernels by
name, elementwise and reduce ops, copies and fills, the rest), the
``TOP`` ops by device time, and the device's busy share of the wall.  On
the CPU (``--cpu``) the same tables hold the host's top-level operators
(no device time exists there).  The trace is written under ``--log-dir``
where given, else into a temporary directory that is removed.  Runs on the
card unless ``--cpu`` is given, and raises when no CUDA device is visible.
On the card the trace records the card's activity alone, which keeps the
profiler's own cost on the host out of the wall.
"""

from __future__ import annotations

import argparse
import collections
import sys
import tempfile
import time

import torch

from another_raytracer_tpu_torch import bench_extra
from another_raytracer_tpu_torch.utils import profiling

RUNS, TOP = 3, 24
# The port's kernels by (a part of) their CUDA names.  K1 and K2 are one
# template instance in two builds, as are K3 and its record instance.
PORT_KERNELS = (
    ("mega_forward_kernel<0>", "K1 / K2 (megakernel sweep)"),
    ("mega_forward_kernel<1>", "K3 / K3 record (megakernel walk)"),
    ("mega_forward_kernel<2>", "K3 / K3 record (megakernel walk)"),
    ("mega_replay_kernel", "replay"),
    ("bvh_kernel", "K5 (BVH closest hit)"),
    ("perlin_kernel", "K4 (Perlin noise)"),
)
COPY_CATEGORIES = ("gpu_memcpy", "gpu_memset")


def category(event) -> str:
    """The category of a trace event: one of the port's kernels, copies
    (and fills), reduce, elementwise or other."""
    name = event["name"]
    for key, label in PORT_KERNELS:
        if key in name:
            return label
    low = name.lower()
    if (event.get("cat") in COPY_CATEGORIES or "copy" in low
            or "memset" in low):
        return "copies and fills"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def top_level(events) -> list:
    """The events not inside another on their thread (the host's operators
    nest: an op's children are part of its time)."""
    out = []
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[e.get("tid")].append(e)
    for evs in by_tid.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (float(e["ts"]),
                                            -float(e["dur"]))):
            if float(e["ts"]) >= end:
                out.append(e)
                end = float(e["ts"]) + float(e["dur"])
    return out


def summarize(events, runs, wall_s) -> dict:
    """Milliseconds a run by category and by op, the busy total and its
    share of ``wall_s`` (the seconds of all runs)."""
    by_cat = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    count = collections.Counter()
    for e in events:
        ms = float(e["dur"]) / 1e3 / runs
        by_cat[category(e)] += ms
        by_op[e["name"]] += ms
        count[e["name"]] += 1
    busy = sum(by_cat.values())
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {"runs": runs, "wall_ms": wall_s * 1e3 / runs, "busy_ms": busy,
            "busy_share": busy / (wall_s * 1e3 / runs) if wall_s else 0.0,
            "by_category": dict(sorted(by_cat.items(),
                                       key=lambda kv: -kv[1])),
            "top": [(name, ms, count[name] / runs) for name, ms in top]}


def trace(name, device, obj_path=None, size=None, log_dir=None) -> dict:
    """Warm up, trace RUNS calls of row ``name`` and summarise them."""
    wl = bench_extra.setup(name, device, obj_path, size)
    dev = wl.scene.device
    call = bench_extra.CALLS[wl.mode](wl)
    call()
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = log_dir or tmp
        with profiling.trace(log_dir, host=dev.type == "cpu"):
            t0 = time.perf_counter()
            for _ in range(RUNS):
                call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_s = time.perf_counter() - t0
        if dev.type == "cuda":
            events = profiling.device_events(log_dir)
        else:
            events = top_level(profiling.device_events(log_dir,
                                                       ("cpu_op",)))
    return {"scene": name, "config": wl.config, "device": dev.type,
            **summarize(events, RUNS, wall_s)}


def report(s: dict, out=print) -> None:
    what = "device" if s["device"] == "cuda" else "host operator"
    out(f"== {s['scene']} ({s['config']}) on {s['device']}: {s['runs']} "
        f"runs, wall {s['wall_ms']:.3f} ms a run, {what} time "
        f"{s['busy_ms']:.3f} ms a run ({s['busy_share']:.1%} of the wall)")
    out(f"--- {what} time by category ---")
    for cat, ms in s["by_category"].items():
        share = ms / s["busy_ms"] if s["busy_ms"] else 0.0
        out(f"   {ms:10.3f} ms/run  {share:6.1%}  {cat}")
    out("--- top individual ops ---")
    for name, ms, n in s["top"]:
        out(f"   {ms:10.3f} ms/run x{n:6.0f}  {name[:110]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=list(bench_extra.CONFIGS))
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="the .obj of the mesh-scene rows")
    p.add_argument("--log-dir", default=None,
                   help="keep the Chrome trace here")
    p.add_argument("--cpu", action="store_true",
                   help="trace on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (use --cpu to trace "
                           "the plain PyTorch versions on the CPU)")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    report(trace(args.name, device, args.obj, log_dir=args.log_dir))
    return 0


if __name__ == "__main__":
    sys.exit(main())
