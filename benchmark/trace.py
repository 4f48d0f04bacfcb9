"""The traced run's reading of the card: a ``torch.profiler`` trace of the
card's activity alone (kernels, copies, fills; the host's operators would
be most of a long trace and of its cost), put on the host's clock by a
marker kernel launched at a known host time, and cut by the spans of the
traced requests: the benchmark's (the request, and an entry's spans inside
it) and the program's."""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TOP = 10
# The port's kernels by a part of their CUDA names, and the categories of
# the rest (as another_raytracer_tpu_torch/trace_scene.py groups them).
PORT_KERNELS = (
    ("mega_forward_kernel<0>", "K1/K2 sweep"),
    ("mega_forward_kernel<1>", "K3 walk"),
    ("mega_forward_kernel<2>", "K3 walk"),
    ("mega_replay_kernel", "replay"),
    ("bvh_kernel", "K5 BVH"),
    ("perlin_kernel", "K4 Perlin"),
)


def category(event: dict) -> str:
    name = event["name"]
    for key, label in PORT_KERNELS:
        if key in name:
            return label
    low = name.lower()
    if event.get("cat") in ("gpu_memcpy", "gpu_memset") or "copy" in low \
            or "memset" in low:
        return "copies and fills"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return "other"


class Profile:
    """Profiles the card over a ``with`` block; ``events`` then holds its
    device activity as (name, category, start us, end us) on the host's
    ``perf_counter`` clock (None when the marker was not found)."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._host_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        dev = [e for e in raw if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATEGORIES]
        marks = [e for e in dev if MARKER in e["name"]]
        self.events = None
        if marks:
            shift = self._host_ns / 1e3 - float(marks[0]["ts"])
            self.events = sorted(
                (e["name"], category(e), float(e["ts"]) + shift,
                 float(e["ts"]) + shift + float(e["dur"]))
                for e in dev if MARKER not in e["name"])
        return False


@dataclasses.dataclass
class Reading:
    """The card's activity over ``n`` traced requests."""

    n: int
    window_s: float  # first traced request's start to the last one's end
    busy_s: float  # the union of the device's activity in the window
    ops: int  # device activities (kernels, copies, fills) in the window
    breakdown: dict


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(events, spans, n) -> Reading:
    """``events`` from ``Profile``; ``spans``: (label, start us, end us) on
    the same clock, the requests labelled ``request``.  The window and the
    busy time are the ``request`` spans'; the longest idle gaps are
    labelled by the innermost span open at their middle."""
    reqs = [s for s in spans if s[0] == "request"]
    lo, hi = min(s[1] for s in reqs), max(s[2] for s in reqs)
    inside = [e for e in events if e[3] > lo and e[2] < hi]
    busy = _union((max(e[2], lo), min(e[3], hi)) for e in inside)
    by_op = collections.defaultdict(float)
    for name, cat, s, e in inside:
        by_op[f"{cat}: {name}"[:160]] += (e - s) / 1e6
    gaps, edge = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((s - edge, (s + edge) / 2))
        edge = max(edge, e)

    def label(mid):
        open_ = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        return (min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_
                else "between requests")

    longest = sorted(gaps, key=lambda g: -g[0])[:TOP]
    return Reading(
        n=n, window_s=(hi - lo) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6, ops=len(inside),
        breakdown={
            "device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": [[label(mid), us / 1e6] for us, mid in longest]})
