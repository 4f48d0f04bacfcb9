"""The benchmark's run: find the cell's files by name, set up, measure a
closed loop of one client for ``--seconds``, read the metrics, decide
``correct`` against the plain reference, and print the result line.

Everything that belongs to one cell, configuration, traffic mix, entry or
metric sits in a file of its own, found by its name:

  * ``BENCHMARK.json`` (the repository's root): the cells, and which
    metric each cell reports;
  * ``workloads/<cell>.json``: the cell's configuration and traffic, and
    the limits of its comparison;
  * ``configs/<config>.json``: the scene as data;
  * ``traffic/<traffic>.json``: the entry, the mode and the sizes of a
    request, and how many requests the traced run profiles (one client,
    a closed loop: the next request starts when the last has returned);
  * ``entries/<entry>.py``: ``setup(ctx)``, ``request(state, i, ctx)``,
    ``counts(state)``, ``release(state)`` (drops the program's objects
    and returns what the comparison needs) and ``check(ctx, kept,
    saved)`` (the compared numbers, run after the window);
  * ``metrics/<metric>.py``: ``read(run)``, the metric's value or None
    where its cell gives it nothing to read.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import random
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
JAX_NAMES = ("jax", "jaxlib", "flax", "another_raytracer_tpu")
THREADS = 2  # host threads of the process's PyTorch
COMPARED = 1  # requests of a window the comparison draws (a whole image)


class UnknownName(ValueError):
    pass


def find(kind: str, name: str, suffix: str, root: Path = ROOT) -> Path:
    """``<root>/<kind>/<name><suffix>``; UnknownName where ``name`` is no
    name or names no file."""
    path = root / kind / f"{name}{suffix}"
    if not NAME.fullmatch(name) or not path.is_file():
        raise UnknownName(f"no {kind} file named {name!r} ({path})")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    with open(find(kind, name, ".json", root)) as f:
        return json.load(f)


def load_module(kind: str, name: str, root: Path = ROOT):
    path = find(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT, overrides=None) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json) with its files;
    ``overrides`` replaces traffic keys (the tests' tiny sizes)."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise UnknownName(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    workload = load_json("workloads", name, root)
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = load_json("configs", entry["config"], root)
    traffic = {**load_json("traffic", entry["traffic"], root),
               **(overrides or {})}
    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


@dataclasses.dataclass
class Context:
    """What an entry gets: the cell, the run's seed, the device and a
    directory for the run's input files."""

    cell: Cell
    seed: int
    device: object
    files_dir: str
    spans: list = dataclasses.field(default_factory=list)
    tracing: bool = False  # the current request is a traced one
    clock: float = dataclasses.field(default_factory=time.perf_counter)

    def note(self, what: str) -> None:
        """Print the seconds since the last note (standard error): the
        steps of set-up."""
        now = time.perf_counter()
        print(f"benchmark: set-up: {what} {now - self.clock:.3f} s",
              file=sys.stderr)
        self.clock = now

    @property
    def config(self):
        return self.cell.config

    @property
    def traffic(self):
        return self.cell.traffic

    @contextlib.contextmanager
    def span(self, label: str):
        """A span of the host's time inside a request (recorded in the
        traced requests only)."""
        t0 = time.perf_counter_ns() / 1e3
        yield
        if self.tracing:
            self.spans.append((label, t0, time.perf_counter_ns() / 1e3))


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    latencies: list  # seconds of every request of the window
    counts: dict  # the scene's primitive counts (``entry.counts``)
    traced: object = None  # trace.Reading of the traced requests, or None
    traced_records: list = dataclasses.field(default_factory=list)  # no image


def traced_spans(ctx: Context) -> list:
    """The traced requests' spans as (label, start us, end us): the
    benchmark's (``request`` and an entry's own) and the program's."""
    from benchmark import spans as spans_lib

    program = spans_lib.recorded() or []
    return ctx.spans + [(s.name, s.start, s.end) for s in program]


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _cache_dirs(repo: Path) -> None:
    """Every compiler cache a library may use, at fixed paths inside the
    checkout (the port builds its kernels into its own ``_build``)."""
    base = repo / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Reservoir:
    """A uniform sample of ``k`` requests of the window, drawn from the
    run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, i, record):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((i, record))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (i, record)


def measure(argv, started: float, age: float = 0.0, device=None,
            bench_path: Path = None, root: Path = ROOT, overrides=None):
    """One run.  Returns (exit code, result dict or None).  ``device``
    None: the card, refused where none is visible; the tests pass
    ``"cpu"`` (the kernels' plain versions)."""
    args = parse(argv)
    bench_path = bench_path or root.parent / "BENCHMARK.json"
    with open(bench_path) as f:
        bench = json.load(f)
    c = cell(bench, args.workload, root, overrides)
    _cache_dirs(root.parent)

    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < c.chips:
            print(f"benchmark: the cell needs {c.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                  "visible", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = device.type == "cuda"

    entry = load_module("entries", c.traffic["entry"], root)
    readers = {m["name"]: load_module("metrics", m["name"], root)
               for m in (c.per_layer if args.trace else c.end_to_end)}
    from benchmark import trace as trace_lib

    with tempfile.TemporaryDirectory() as files_dir:
        ctx = Context(cell=c, seed=args.seed, device=device,
                      files_dir=files_dir, clock=started)
        ctx.note(f"imports (the process began {age:.3f} s before)")
        state = entry.setup(ctx)
        if on_card:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - started + age

        n_trace = int(c.traffic["traced_requests"]) if args.trace else 0
        keep = Reservoir(COMPARED, args.seed)
        latencies, traced, prof = [], [], None
        t_end = time.perf_counter() + args.seconds
        i = 0
        while True:
            if i == 0 and n_trace and on_card:
                prof = trace_lib.Profile().__enter__()
            ctx.tracing = i < n_trace
            t0 = time.perf_counter_ns() / 1e3
            record = entry.request(state, i, ctx)
            t1 = time.perf_counter_ns() / 1e3
            if ctx.tracing:
                ctx.spans.append(("request", t0, t1))
                traced.append({k: v for k, v in record.items()
                               if k != "image"})
            latencies.append((t1 - t0) / 1e6)
            keep.offer(i, record)
            i += 1
            if prof is not None and i == n_trace:
                prof.__exit__(None, None, None)
            if t1 / 1e6 >= t_end and i >= n_trace:
                break

        lat = sorted(latencies)
        tenths = [latencies[k * len(latencies) // 10:
                            (k + 1) * len(latencies) // 10]
                  for k in range(10)]
        print(f"benchmark: {len(lat)} requests, ms min {lat[0] * 1e3:.3f} "
              f"median {lat[len(lat) // 2] * 1e3:.3f} max "
              f"{lat[-1] * 1e3:.3f}; mean by tenth of the window "
              f"{[round(sum(t) / len(t) * 1e3, 3) for t in tenths if t]}",
              file=sys.stderr)
        found = sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))
        if found:
            print(f"benchmark: the run loaded {', '.join(found)}",
                  file=sys.stderr)
            return 3, None
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        run = Run(cell=c, setup_s=setup_s, latencies=latencies,
                  counts=entry.counts(state),
                  traced_records=traced)
        if prof is not None and prof.events is not None:
            run.traced = trace_lib.read(prof.events, traced_spans(ctx),
                                        n_trace)
        metrics = {}
        for m in (c.per_layer if args.trace else c.end_to_end):
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

        saved = entry.release(state)
        del state
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = entry.check(ctx, keep.kept, saved)
        print(f"benchmark: the comparison took "
              f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": len(latencies), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if on_card else "cpu"),
                         "count": c.chips, "memory_peak_bytes": int(peak)}}
    if run.traced is not None:
        result["device"].update(busy_s=run.traced.busy_s,
                                window_s=run.traced.window_s)
        result["breakdown"] = run.traced.breakdown
    if on_card:
        result["card"] = card_line()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return 0, result


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


def main(argv, started: float) -> int:
    age = process_age()
    try:
        rc, result = measure(argv, started, age)
    except UnknownName as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if result is None:
        return rc
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return rc
