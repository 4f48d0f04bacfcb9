"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program.  Top-level module names are compared whole: the
program ``another_raytracer_tpu_torch`` begins with the JAX package's
name and is allowed."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "another_raytracer_tpu"}
PROGRAM = "another_raytracer_tpu_torch"


def top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Every cell, traced and not, at a tiny size on the CPU."""
    code = f"""
import json, sys, time
from benchmark import harness
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    for trace in ("0", "1"):
        rc, res = harness.measure(
            ["--workload", w["name"], "--seed", "7", "--seconds", "0.1",
             "--trace", trace], time.perf_counter(), device="cpu",
            overrides={{"width": 24, "height": 24, "spp": 2, "max_depth": 2}})
        assert rc == 0 and res["attempted"] >= 1
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    names = top_levels(code)
    assert PROGRAM in names
    assert not names & JAX


def test_the_reference_loads_nothing_of_the_program():
    code = """
import json, sys, torch
from benchmark.reference import adaptive, scene, tracer, train
cfg = json.load(open("benchmark/configs/cornell_box.json"))
sc = scene.build(cfg, [], "cpu")
img, seg = tracer.render(sc, tracer.camera(cfg["camera"], 24, 24), width=24,
                         height=24, spp=1, max_depth=2, seed=1)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    names = top_levels(code)
    assert not names & (JAX | {PROGRAM})


def test_the_reference_sources_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in JAX | {PROGRAM}, path
