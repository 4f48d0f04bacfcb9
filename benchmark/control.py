"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's
(``precision`` float32 -> bfloat16; the tracer has no matrix products, so
TF32 would change nothing), and judged by the cell's own comparison.  It
has to come out not correct: its readings set the upper end of each limit.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

prints one JSON line a seed with the compared numbers, on the card."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from benchmark import harness, inputs
from benchmark.reference import adaptive as ref_adaptive
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer as ref_tracer
from benchmark.reference import train as ref_train

BELOW = {"float32": torch.bfloat16}  # a configuration's precision -> the control's


def readings(c: harness.Cell, seed: int, device, root: Path = harness.ROOT):
    """[(name, value, limit)] of the control of cell ``c`` on ``seed``."""
    entry = harness.load_module("entries", c.traffic["entry"], root)
    dtype = BELOW[c.config["precision"]]
    tr, cfg = c.traffic, c.config
    kw = dict(width=tr["width"], height=tr["height"], spp=tr["spp"],
              max_depth=tr["max_depth"])
    with tempfile.TemporaryDirectory() as files_dir:
        ctx = harness.Context(cell=c, seed=seed, device=torch.device(device),
                              files_dir=files_dir)
        files = inputs.write_inputs(cfg, files_dir)
        sc = ref_scene.build(cfg, files, ctx.device, dtype=dtype)
        cam = ref_tracer.camera(cfg["camera"], tr["width"], tr["height"])
        if tr["entry"] == "train":
            target = inputs.target_image(seed, tr["width"], tr["height"],
                                         ctx.device)
            leaves = {k: sc.leaves[k] for k in cfg["trainable"]}
            steps = getattr(entry, "CHECKED_STEPS", 3)
            losses, first, after = ref_train.adam_steps(
                sc, cam, leaves, target.to(dtype),
                [inputs.request_seed(seed, k) for k in range(1, steps + 1)],
                cfg["learning_rate"], **kw)
            saved = entry.State(step=None, train=None, target=target,
                                counts={}, losses=losses, first_grad=first,
                                change={k: after[k] - leaves[k]
                                        for k in leaves})
            return entry.check(ctx, [], saved)
        rseed = inputs.request_seed(seed, 0)
        if tr["mode"] == "adaptive":
            img, segments, traced = ref_adaptive.render(sc, cam, seed=rseed,
                                                        **kw)
        else:
            (img, segments), traced = ref_tracer.render(
                sc, cam, seed=rseed, **kw), None
        record = {"image": img, "segments": segments, "traced": traced}
        return entry.check(ctx, [(0, record)], files)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    with open(harness.ROOT.parent / "BENCHMARK.json") as f:
        c = harness.cell(json.load(f), args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device is visible", file=sys.stderr)
        return 2
    for seed in map(int, args.seeds.split(",")):
        checks = readings(c, seed, "cuda")
        print(json.dumps({"workload": c.name, "seed": seed,
                          "control": str(BELOW[c.config["precision"]]),
                          "checks": {k: v for k, v, _ in checks},
                          "fails": [k for k, v, lim in checks if v > lim]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
