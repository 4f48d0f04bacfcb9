"""The comparison's own checks: the control (the reference one precision
below the configuration's, in the program's place) comes out not correct,
and so does a run with each fault of ``benchmark/faults.py`` planted under
the timed path, while a sound run comes out correct.  On the CPU at a
tiny size; the control at each cell's own size on the card (``cuda``)."""

import json
import time
from pathlib import Path

import pytest

from benchmark import control, faults, harness

REPO = Path(__file__).resolve().parents[2]
TINY = {"width": 48, "height": 36, "spp": 4, "max_depth": 4}
SEEDS = (3_000_000_011, 3_000_000_012, 3_000_000_013)
# Every cell file, listed in BENCHMARK.json or not yet.
CELLS = sorted(p.name[:-5] for p in (harness.ROOT / "workloads").glob("*.json"))


def bench():
    """BENCHMARK.json with every cell file as a cell of its own."""
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in b["workloads"]}
    for name in CELLS:
        if name not in listed:
            w = harness.load_json("workloads", name)
            b["workloads"].append({"name": name, "config": w["config"],
                                   "traffic": w["traffic"], "chips": 1})
    return b


def cell(name, overrides=TINY):
    return harness.cell(bench(), name, overrides=overrides)


def run(name, seed, tmp_path):
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench()))
    rc, res = harness.measure(
        ["--workload", name, "--seed", str(seed), "--seconds", "0.2"],
        time.perf_counter(), device="cpu", bench_path=path, overrides=TINY)
    assert rc == 0
    return res


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, tmp_path):
    assert run(name, SEEDS[0], tmp_path)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    c = cell(name)
    for seed in SEEDS:
        checks = control.readings(c, seed, "cpu")
        assert any(v > limit for _, v, limit in checks), checks


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault, tmp_path):
    with faults.planted(cell(name).traffic["entry"], fault):
        res = run(name, SEEDS[1], tmp_path)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    c = cell(name, overrides=None)
    for seed in SEEDS:
        checks = control.readings(c, seed, card)
        assert any(v > limit for _, v, limit in checks), checks
