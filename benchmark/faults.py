"""Faults planted in the program under a run, to show that the comparison
catches them (each has to make ``correct`` false).  For the render entry a
request's answer is its image; for the train entry, a step.

  * ``unchanged``: a step that returns its state unchanged (the training
    leaves are put back after the step; a render returns the first image it
    made, whatever the request);
  * ``half_batch``: half of the batch left out, the mean taken over the
    rest (a render of half the samples; a loss over half the pixels);
  * ``altered``: an answer altered where it is produced (a render's first
    12 x 12 square moved by 64 levels; a step's loss, and so its gradient,
    scaled by 1.01).

The exchange between chips does not exist on one chip.

    python3 -m benchmark.faults --workload <cell> --fault <fault> --seeds 1,2,3

runs the cell as ``benchmark.run`` does, for a 2-second window, with the
fault planted and prints one JSON line a seed: ``correct`` and the
compared numbers."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

FAULTS = ("unchanged", "half_batch", "altered")
SHIFT = 64  # levels an altered image's square moves


def _render_fault(fault, real):
    first = {}

    def render(scene, cam, config, **kw):
        if fault == "half_batch":
            return real(scene, cam, config.replace(
                samples_per_pixel=max(1, config.samples_per_pixel // 2)),
                **kw)
        if fault == "unchanged":
            if "answer" not in first:
                first["answer"] = real(scene, cam, config, **kw)
            return first["answer"]
        img, stats = real(scene, cam, config, **kw)
        img = img.copy()
        img[:12, :12] = (img[:12, :12].astype(int) + SHIFT).clip(0, 255)
        return img, stats

    return render


def _half_loss(diff, render_lib):
    import torch

    def render_loss(params, scene, cam, target, seed, *, width, height, spp,
                    samples_per_pass, max_depth, t_min, partition=None):
        s = diff.merge_params(scene, params)
        n = width * height // 2
        pixel_ids = torch.arange(n, dtype=torch.int64, device=s.device)
        acc, _ = render_lib.radiance_batch(
            s, cam, pixel_ids, seed, width=width, height=height,
            sample_start=0, n_samples=spp, spp_cap=spp,
            samples_per_pass=samples_per_pass, max_depth=max_depth,
            t_min=t_min, differentiable=True, trainable=tuple(sorted(params)))
        return sum(torch.mean((c / spp - target[:n, i]) ** 2)
                   for i, c in enumerate(acc)) / 3.0

    return render_loss


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Plant ``fault`` in the program's path of ``entry`` for the block."""
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.ops import render as render_lib

    if entry == "render":
        module, name = render_lib, "render"
        new = _render_fault(fault, render_lib.render)
    elif fault == "unchanged":
        module, name, real = diff, "make_train_step", diff.make_train_step

        def new(*args, **kw):
            state, step = real(*args, **kw)

            def kept(state, seed):
                saved = {k: v.detach().clone()
                         for k, v in state.params.items()}
                state, loss = step(state, seed)
                for k, v in state.params.items():
                    v.data.copy_(saved[k])
                return state, loss

            return state, kept
    else:
        module, name, real = diff, "render_loss", diff.render_loss
        new = (_half_loss(diff, render_lib) if fault == "half_batch"
               else lambda *a, **kw: real(*a, **kw) * 1.01)
    saved = getattr(module, name)
    setattr(module, name, new)
    try:
        yield
    finally:
        setattr(module, name, saved)


def main(argv=None) -> int:
    from benchmark import harness

    p = argparse.ArgumentParser(prog="python3 -m benchmark.faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=FAULTS)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    with open(harness.ROOT.parent / "BENCHMARK.json") as f:
        entry = harness.cell(json.load(f), args.workload).traffic["entry"]
    for seed in args.seeds.split(","):
        with planted(entry, args.fault):
            rc, res = harness.measure(
                ["--workload", args.workload, "--seed", seed, "--seconds",
                 "2"], time.perf_counter())
        if res is None:
            return rc
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": int(seed), "correct": res["correct"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
