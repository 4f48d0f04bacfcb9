"""Entry ``train``: a request is one step of
``grad.diff.make_train_step`` (forward, backward and the adam update of
the configuration's trainable leaves at its learning rate), ended by
reading the loss on the host.  The target is ``inputs.target_image`` of
the run's seed; step ``k`` (from 1) traces with the sample seed
``inputs.request_seed(seed, k)``.

Set-up builds the one training object and drives it through steps 1-3,
which are its warm-up; the window continues the same object from step 4.
The comparison follows those three steps with the plain reference: each
step's loss (``loss_gap``), the first gradient as adam's state holds it
after step 1 (``grad_gap``), and the leaves' change over the three steps
(``step_gap``), the latter two by the worst leaf."""

from __future__ import annotations

import dataclasses

from benchmark import compare, inputs, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer as ref_tracer
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3


@dataclasses.dataclass
class State:
    step: object
    train: object
    target: object
    counts: dict
    steps: int = 0
    losses: list = dataclasses.field(default_factory=list)
    first_grad: dict = None
    start: dict = None
    change: dict = None


def setup(ctx):
    import torch

    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.ops.kernels import _build

    if ctx.device.type == "cuda":
        _build.build_all()  # every target at once; a built one is kept
    ctx.note("kernels built or found")
    tr, cfg = ctx.traffic, ctx.config
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, ctx.files_dir),
                              tr["width"], tr["height"], ctx.device)
    ctx.note("scene")
    target = inputs.target_image(ctx.seed, tr["width"], tr["height"],
                                 ctx.device)
    ctx.note("target")
    train, step = diff.make_train_step(
        scene, cam, target, width=tr["width"], height=tr["height"],
        spp=tr["spp"], samples_per_pass=1, max_depth=tr["max_depth"],
        learning_rate=cfg["learning_rate"], trainable=tuple(cfg["trainable"]))
    state = State(step=step, train=train, target=target,
                  counts={"rects": scene.n_rects, "spheres": scene.n_spheres,
                          "triangles": scene.n_triangles,
                          "media": scene.n_media})
    state.start = {k: v.detach().clone() for k, v in train.params.items()}
    ctx.note("train step built")
    beta1 = train.opt_state.defaults["betas"][0]
    for k in range(CHECKED_STEPS):
        state.losses.append(request(state, k, ctx)["loss"])
        if k == 0:
            opt = train.opt_state.state
            state.first_grad = {
                name: (opt[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                for name, p in train.params.items()}
    state.change = {k: (v.detach() - state.start[k]).to(torch.float64)
                    for k, v in train.params.items()}
    ctx.note(f"steps 1-{CHECKED_STEPS}")
    return state


def request(state, i, ctx) -> dict:
    state.steps += 1
    with ctx.span("step"):
        state.train, loss = state.step(
            state.train, inputs.request_seed(ctx.seed, state.steps))
    with ctx.span("loss read"):
        value = loss.item()
    return {"loss": value, "step": state.steps}


def counts(state) -> dict:
    return state.counts


def release(state) -> State:
    state.step = state.train = None
    return state


def check(ctx, kept, state) -> list:
    tr, cfg = ctx.traffic, ctx.config
    sc = ref_scene.build(cfg, inputs.write_inputs(cfg, ctx.files_dir),
                         ctx.device)
    cam = ref_tracer.camera(cfg["camera"], tr["width"], tr["height"])
    leaves = {k: sc.leaves[k] for k in cfg["trainable"]}
    losses, first, after = ref_train.adam_steps(
        sc, cam, leaves, state.target.double(),
        [inputs.request_seed(ctx.seed, k)
         for k in range(1, CHECKED_STEPS + 1)],
        cfg["learning_rate"], width=tr["width"], height=tr["height"],
        spp=tr["spp"], max_depth=tr["max_depth"])
    moved = compare.moved_leaves(first)
    numbers = {
        "loss_gap": max(compare.rel_gap(p, r)
                        for p, r in zip(state.losses, losses)),
        "grad_gap": compare.leaf_gap(state.first_grad, first),
        "step_gap": compare.leaf_gap(
            state.change, {k: after[k] - leaves[k] for k in leaves},
            only=moved)}
    return compare.verdict(numbers, ctx.cell.workload["limits"])
