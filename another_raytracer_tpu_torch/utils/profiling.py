"""Profiling and metrics (port of ``another_raytracer_tpu.utils.profiling``
on ``torch.profiler``).

  * ``trace(log_dir)`` records a region's CPU activity (unless
    ``host=False``), and its CUDA activity where a card is visible, into a
    Chrome trace in ``log_dir``;
  * ``device_seconds(log_dir)`` sums the device activity of the newest
    trace there (the counterpart of JAX's ``module_device_seconds``);
  * ``RayStats`` accumulates honest segment counts (bounce rays included)
    and derives Mrays/s;
  * ``timed(label)`` brackets a region with the host clock after
    synchronising the card, so the bracket holds the device's work; it
    yields a ``Timing`` that holds the seconds once the region ends;
  * ``card_line()`` is the card's name and power limit, written beside
    every time taken on it;
  * ``span(name, **attrs)`` records a span of the host's time at a layer
    boundary of the program (``Span``), while a ``torch.profiler`` session
    is active in the process or inside ``recording()``; ``count(**counts)``
    adds counts to the innermost open one; ``spans()`` returns them and
    ``clear_spans()`` forgets them.

The CLI times its render with ``timed`` and prints ``RayStats``' Mrays/s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import os
import subprocess
import time

import torch

# Chrome-trace categories of device activity: kernels, copies and fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, host: bool = True):
    """Profile the region and write ``<log_dir>/trace-<ns>.json``.
    ``host=False`` records the card's activity alone: the host's operators
    are most of a long trace's events and of the profiler's cost.  The
    profiler turns span recording on; the spans recorded in the region are
    dropped at its end, so a caller that reads them does so inside it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(_spans)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        del _spans[first:]
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace-{time.time_ns()}.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Timing:
    seconds: float = 0.0


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Time the region on the host clock, the card synchronised at both
    ends; ``sink`` (None: no line) gets ``"<label>: <ms> ms"``."""
    timing = Timing()
    _sync()
    t0 = time.perf_counter()
    yield timing
    _sync()
    timing.seconds = time.perf_counter() - t0
    if sink is not None:
        sink(f"{label}: {timing.seconds * 1000:.1f} ms")


@dataclasses.dataclass
class RayStats:
    """Honest throughput accounting (vs the reference's primary-only
    ``W*H*spp/ms`` at main.cpp:50-53, which ignores bounces and adaptive
    skipping)."""

    segments: int = 0
    seconds: float = 0.0

    def add(self, segments: int, seconds: float):
        self.segments += int(segments)
        self.seconds += seconds

    @property
    def mrays_per_s(self) -> float:
        return self.segments / self.seconds / 1e6 if self.seconds else 0.0


def device_events(log_dir: str, categories=DEVICE_CATEGORIES) -> list:
    """The complete events of ``categories`` (default the device activity,
    ``DEVICE_CATEGORIES``; ``("cpu_op",)`` the host's operators) of the
    newest trace under ``log_dir``."""
    files = glob.glob(os.path.join(log_dir, "trace-*.json"))
    if not files:
        raise FileNotFoundError(f"no profiler trace under {log_dir}")
    newest = max(files, key=lambda p: int(p.rsplit("-", 1)[1][:-5]))
    with open(newest) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in categories]


def device_seconds(log_dir: str) -> float:
    """Summed duration of the device activity in the newest trace under
    ``log_dir``.  Raises RuntimeError when the trace holds none (a CPU run,
    or a profiler that could not trace the card)."""
    events = device_events(log_dir)
    if not events:
        raise RuntimeError(f"the trace under {log_dir} holds no device "
                           "activity")
    return sum(float(e["dur"]) for e in events) / 1e6


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: ``start`` and ``end`` in microseconds on
    ``time.perf_counter_ns() / 1e3`` (the clock the benchmark puts the
    card's activity on), ``parent`` the index in ``spans()`` of the span it
    opened inside (-1 for a root), ``request`` shared by every span under
    one root, ``attrs`` its counts (lanes, widths)."""

    name: str
    start: float
    end: float
    parent: int
    request: int
    attrs: dict


_spans: list = []  # every recorded Span, in the order they opened
_open: list = []  # the open spans (_On), innermost last
_forced = 0  # depth of the open ``recording()`` blocks
_requests = 0  # request ids handed out
_profiler_on = torch._C._autograd._profiler_enabled


class _Off:
    """The span while recording is off: one shared instance, no work."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("record", "index")

    def __init__(self, name, attrs):
        self.record = Span(name, 0.0, 0.0, -1, -1, attrs)

    def __enter__(self):
        global _requests
        rec = self.record
        if _open:
            up = _open[-1]
            rec.parent, rec.request = up.index, up.record.request
        else:
            rec.request = _requests
            _requests += 1
        self.index = len(_spans)
        _spans.append(rec)
        _open.append(self)
        rec.start = time.perf_counter_ns() / 1e3
        return self

    def __exit__(self, *exc):
        self.record.end = time.perf_counter_ns() / 1e3
        _open.pop()
        return False

    def count(self, **counts):
        """Add counts known only once the span's work is done."""
        self.record.attrs.update(counts)


def span(name: str, **attrs):
    """A context manager that records the span ``name`` with ``attrs``
    (counts) while a ``torch.profiler`` session is active in the process or
    inside ``recording()``; otherwise one shared context manager that does
    nothing.  It launches nothing on the card and reads nothing from it.
    What it enters as has ``count(**counts)``, which adds counts to the
    span (nothing where it records none)."""
    if _forced or _profiler_on():
        return _On(name, attrs)
    return _OFF


def count(**counts):
    """Add counts to the innermost open span: counts that code deep inside
    the span's work knows, where the span's owner cannot hand it the span
    (nothing where no span records)."""
    if _open:
        _open[-1].record.attrs.update(counts)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> list:
    """The recorded spans (``Span``), in the order they opened."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()
