"""The harness finds what it runs by name: a configuration, a cell and a
per-layer metric added as files alone run; an unknown name is refused; a
run without a card fails instead of falling back to the CPU."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY = {"width": 24, "height": 24, "spp": 2, "max_depth": 2,
        "traced_requests": 2}


def copy_benchmark(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    return root, bench


def measure(root, bench, tmp_path, cell, trace=0, **kw):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return harness.measure(
        ["--workload", cell, "--seed", "2500000000", "--seconds", "0.2",
         "--trace", str(trace)], time.perf_counter(), device="cpu",
        bench_path=path, root=root, overrides=TINY, **kw)


def test_new_files_are_found_by_name(tmp_path):
    """A configuration (the Cornell box with a brighter light), its cell
    and a per-layer metric (requests a second, from the host's clock), each
    a new file and a new entry of BENCHMARK.json, run on the CPU."""
    root, bench = copy_benchmark(tmp_path)
    cfg = json.loads((root / "configs" / "cornell_box.json").read_text())
    cfg["materials"][3]["color"] = [30.0, 30.0, 30.0]
    (root / "configs" / "bright_box.json").write_text(json.dumps(cfg))
    limits = {"image_mad": 0.5, "tile_gap": 40.0, "segments_gap": 0.02}
    (root / "workloads" / "bright_box.render.json").write_text(json.dumps(
        {"config": "bright_box", "traffic": "single_720x540_spp16_d8",
         "limits": limits}))
    (root / "metrics" / "requests_per_s.render.py").write_text(
        "def read(run):\n"
        "    return len(run.latencies) / sum(run.latencies)\n")
    bench["configs"].append({"name": "bright_box", "source": "test",
                             "file": "benchmark/configs/bright_box.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "bright_box.render",
                               "config": "bright_box",
                               "traffic": "single_720x540_spp16_d8",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_per_s.render",
                               "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "render_ms",
                               "workloads": ["bright_box.render"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("render_ms", "setup_s"):
            m.setdefault("workloads", []).append("bright_box.render")
    rc, res = measure(root, bench, tmp_path, "bright_box.render")
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"render_ms", "setup_s"}
    rc, res = measure(root, bench, tmp_path, "bright_box.render", trace=1)
    assert rc == 0 and res["metrics"]["requests_per_s.render"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_unknown_names_are_refused(tmp_path):
    root, bench = copy_benchmark(tmp_path)
    with pytest.raises(harness.UnknownName):
        measure(root, bench, tmp_path, "no_such.cell")
    bench["per_layer"].append({"name": "no_such_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels", "moves": "render_ms"})
    with pytest.raises(harness.UnknownName):
        measure(root, bench, tmp_path, "cornell_box.render", trace=1)
    with pytest.raises(harness.UnknownName):
        harness.find("configs", "../BENCHMARK", ".json", root)


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cornell_box.render", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_are_not_enough(tmp_path):
    """A checkout that holds BENCHMARK.json and benchmark/ alone (no
    program) exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cornell_box.render", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "cornell_box.render", "--seed", "3000000017", "--seconds", "2",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
