"""Profiler trace of one ``bench_extra`` row, summarised by kernel category,
by op and by the port's spans (the counterpart of the JAX package's
``scripts/trace_scene.py`` with ``trace_probe.summarize`` and
``summarize_ops``).

    python -m another_raytracer_tpu_torch.trace_scene NAME [--obj PATH]
        [--size W H SPP DEPTH] [--entry] [--log-dir DIR] [--cpu]

Runs the row's call once to warm up (kernel builds, table packing), then
traces ``RUNS`` calls with ``torch.profiler`` (``utils.profiling.trace``):
the render of a forward or adaptive row, the fwd+bwd step of a gradient
row; ``--entry`` takes the port's entry points instead (``ops.render.render``
with the uint8 image on the host for a forward row, an adam step of
``diff.make_train_step`` for a gradient row) and ``--size`` the row's size.
Prints the device time a run by category (the port's kernels by name,
elementwise and reduce ops, copies and fills, the rest), the ``TOP`` ops by
device time, and the device's busy share of the wall.  Then the spans the
port recorded (``utils.profiling.span``): calls and host ms a run, the same
over ``RUNS`` calls without a profiler (inside ``profiling.recording()``;
the profiler slows every launch), the device's idle ms a run in each span
(a gap between the card's activities goes to the innermost span open at its
middle) and the ``GAPS`` longest gaps; last the ``render`` span's counts
a run, ``segments`` and, where the wavefront renders spheres,
``sphere_hits``, where it renders media, ``medium_scatters``, and the
wavefront's iterations a run by their ``rearm`` (``kernel`` where the
bounce kernel re-armed the lanes).  On the CPU
(``--cpu``) the tables hold the host's top-level operators (no device time
exists there, nor idle time).  The
trace is written under ``--log-dir`` where given, else into a
temporary directory that is removed.  Runs on the card unless ``--cpu`` is
given, and raises when no CUDA device is visible.  On the card the trace
records the card's activity alone, which keeps the profiler's own cost on
the host out of the wall, and starts with a marker kernel launched at a
known time of the host's clock, which puts the card's activity on the
spans' clock.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import sys
import tempfile
import time
from typing import Callable

import torch

from another_raytracer_tpu_torch import bench_extra
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.utils import profiling

RUNS, TOP, GAPS = 3, 24, 10
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
OUTSIDE = "(no span)"  # idle time while no span is open
# The port's kernels by (a part of) their CUDA names.  K1 and K2 are one
# template instance in two builds, as are K3 and its record instance.
PORT_KERNELS = (
    ("mega_forward_kernel<0>", "K1 / K2 (megakernel sweep)"),
    ("mega_forward_kernel<1>", "K3 / K3 record (megakernel walk)"),
    ("mega_forward_kernel<2>", "K3 / K3 record (megakernel walk)"),
    ("mega_replay_kernel", "replay"),
    ("bvh_kernel", "K5 (BVH closest hit)"),
    ("perlin_kernel", "K4 (Perlin noise)"),
    ("uniform2_draws_kernel", "draws (threefry uniform2)"),
    ("bounce_kernel", "bounce (wavefront step after K5)"),
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


def entry_call(wl) -> Callable:
    """Row ``wl`` through the port's entry points: a render through
    ``ops.render.render`` in the row's mode (the uint8 image on the host),
    or for a gradient row an adam step of ``diff.make_train_step`` towards a
    black image."""
    w, h, spp, depth = wl.size
    if wl.mode != "grad":
        mode = (RenderMode.ADAPTIVE if wl.mode == "adaptive"
                else RenderMode.SINGLE)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth, seed=bench_extra.SEED,
                           t_min=bench_extra.T_MIN, mode=mode)
        return lambda: render_lib.render(wl.scene, wl.cam, cfg)
    target = torch.zeros((w * h, 3), dtype=torch.float32,
                         device=wl.scene.device)
    state, step = diff.make_train_step(
        wl.scene, wl.cam, target, trainable=bench_extra.GRAD_TRAINABLE,
        **bench_extra._kw(wl.size))
    return lambda: step(state, bench_extra.SEED)


def _mark(dev) -> float:
    """Launch the marker kernel and return the host time of its launch, in
    us on ``perf_counter_ns``.  One op runs to its end first: the first
    launch under a profiler starts late, and the marker must not."""
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize(dev)
    host_us = time.perf_counter_ns() / 1e3
    torch.cuda._sleep(1000)
    return host_us


def on_host_clock(events, host_us) -> list:
    """The device events that start after the marker, their ``ts`` moved
    onto the host's clock (the marker's start is ``host_us``)."""
    mark = min(float(e["ts"]) for e in events if MARKER in e["name"])
    return [dict(e, ts=float(e["ts"]) - mark + host_us) for e in events
            if float(e["ts"]) > mark]


def innermost(spans):
    """(times, names): ``names[i]`` is the innermost span open from
    ``times[i]`` to ``times[i + 1]`` (None where none is)."""
    times, names, open_ = [], [], []

    def edge(t):
        times.append(t)
        names.append(open_[-1][1] if open_ else None)

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while open_ and open_[-1][0] <= s.start:
            edge(open_.pop()[0])
        open_.append((s.end, s.name))
        edge(s.start)
    while open_:
        edge(open_.pop()[0])
    return times, names


def span_table(spans, runs, events=None, bare=None) -> dict:
    """By span name: calls and host ms a run (``bare``: the spans of
    ``runs`` calls without a profiler, whose ms go beside); with ``events``
    (the card's activity on the host's clock) the device's idle ms a run,
    each gap between its activities, from the first root span's start to
    the last one's end, going to the innermost span open at its middle
    (``OUTSIDE`` where none is), and the ``GAPS`` longest gaps."""
    table = collections.defaultdict(
        lambda: {"calls": 0.0, "ms": 0.0, "bare_ms": None, "idle_ms": None})
    for s in spans:
        table[s.name]["calls"] += 1 / runs
        table[s.name]["ms"] += (s.end - s.start) / 1e3 / runs
    for s in bare or ():
        row = table[s.name]
        row["bare_ms"] = (row["bare_ms"] or 0.0) + (s.end - s.start) / 1e3 / runs
    out = {"spans": dict(table), "gaps": None}
    roots = [s for s in spans if s.parent < 0]
    if events is None or not roots:
        return out
    lo, hi = min(s.start for s in roots), max(s.end for s in roots)
    times, names = innermost(spans)
    gaps, edge = [], lo
    for e in sorted(events, key=lambda e: e["ts"]) + [{"ts": hi, "dur": 0}]:
        start, end = max(e["ts"], lo), min(e["ts"] + float(e["dur"]), hi)
        if start > edge:
            mid = (start + edge) / 2
            i = bisect.bisect_right(times, mid) - 1
            gaps.append(((names[i] if i >= 0 else None) or OUTSIDE,
                         (start - edge) / 1e3))
        edge = max(edge, end)
        if edge >= hi:
            break
    for name, ms in gaps:
        row = table[name]
        row["idle_ms"] = (row["idle_ms"] or 0.0) + ms / runs
    if OUTSIDE in table:
        table[OUTSIDE].update(calls=None, ms=None)
    out["spans"] = dict(table)
    out["gaps"] = sorted(gaps, key=lambda g: -g[1])[:GAPS]
    out["idle_ms"] = sum(ms for _, ms in gaps) / runs
    return out


def render_counts(spans, runs) -> dict:
    """The counts of the ``render`` root spans (``segments``,
    ``sphere_hits``, ``medium_scatters``) a run, those that some span
    holds."""
    roots = [s for s in spans if s.parent < 0 and s.name == "render"]
    return {k: sum(s.attrs.get(k, 0) for s in roots) / runs
            for k in ("segments", "sphere_hits", "medium_scatters")
            if any(k in s.attrs for s in roots)}


def rearm_counts(spans, runs) -> dict:
    """The wavefront's iterations a run by how their lanes were re-armed,
    the ``rearm`` count of ``wavefront.iteration``: ``kernel`` (the bounce
    kernel's step), ``ops`` (the re-arm's ops) or ``none``."""
    its = collections.Counter(s.attrs.get("rearm") for s in spans
                              if s.name == "wavefront.iteration")
    return {str(k): v / runs for k, v in sorted(its.items(), key=str)}


def trace(name, device, obj_path=None, size=None, log_dir=None,
          entry=False) -> dict:
    """Warm up, trace RUNS calls of row ``name`` (through ``entry_call``
    where ``entry``), time RUNS more without a profiler, summarise them."""
    wl = bench_extra.setup(name, device, obj_path, size)
    dev = wl.scene.device
    call = (entry_call if entry else bench_extra.CALLS[wl.mode])(wl)
    call()
    with profiling.recording():
        first = len(profiling.spans())
        for _ in range(RUNS):
            call()
        bare = profiling.spans()[first:]
    profiling.clear_spans()
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = log_dir or tmp
        with profiling.trace(log_dir, host=dev.type == "cpu"):
            mark = _mark(dev) if dev.type == "cuda" else None
            first = len(profiling.spans())
            t0 = time.perf_counter()
            for _ in range(RUNS):
                call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall_s = time.perf_counter() - t0
            spans = profiling.spans()[first:]
        if dev.type == "cuda":
            events = on_host_clock(profiling.device_events(log_dir), mark)
        else:
            events = top_level(profiling.device_events(log_dir,
                                                       ("cpu_op",)))
    return {"scene": name, "config": wl.config, "device": dev.type,
            "entry": entry, "counts": render_counts(spans, RUNS),
            "rearm": rearm_counts(spans, RUNS),
            **summarize(events, RUNS, wall_s),
            **span_table(spans, RUNS,
                         events if dev.type == "cuda" else None, bare)}


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
    out("--- spans, a run: calls, host ms traced, host ms unprofiled, "
        "device idle ms ---")
    for name, row in sorted(s["spans"].items(),
                            key=lambda kv: -(kv[1]["ms"] or 0.0)):
        cols = [f"{'-' if row[k] is None else format(row[k], f):>{w}}"
                for k, f, w in (("calls", ".1f", 8), ("ms", ".3f", 10),
                                ("bare_ms", ".3f", 10),
                                ("idle_ms", ".3f", 10))]
        out(f"   {'  '.join(cols)}  {name}")
    if s["gaps"] is not None:
        out(f"--- the {len(s['gaps'])} longest idle gaps of "
            f"{s['idle_ms']:.3f} ms a run, by innermost span ---")
        for name, ms in s["gaps"]:
            out(f"   {ms:10.3f} ms  {name}")
    if s["counts"]:
        out("--- the render span's counts a run: " + ", ".join(
            f"{k} {v:.1f}" for k, v in s["counts"].items()) + " ---")
    if s["rearm"]:
        out("--- wavefront iterations a run by re-arm: " + ", ".join(
            f"{k} {v:.1f}" for k, v in s["rearm"].items()) + " ---")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("name", choices=list(bench_extra.CONFIGS))
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="the .obj of the mesh-scene rows")
    p.add_argument("--size", type=int, nargs=4, default=None,
                   metavar=("W", "H", "SPP", "DEPTH"),
                   help="trace at this size in place of the row's")
    p.add_argument("--entry", action="store_true",
                   help="trace the port's entry point: ops.render.render, "
                        "or an adam step of diff.make_train_step")
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
    report(trace(args.name, device, args.obj, args.size, args.log_dir,
                 args.entry))
    return 0


if __name__ == "__main__":
    sys.exit(main())
