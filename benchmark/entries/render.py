"""Entry ``render``: a request is one ``ops.render.render(scene, cam,
RenderConfig)`` call, the call the program's command line makes, which
returns the uint8 image on the host.  Request ``i`` renders with the sample
seed ``inputs.request_seed(seed, i)``.

Its comparison renders the sampled requests again with the plain reference
from the configuration and the same input files: the uint8 image over
every pixel (``image_mad``, ``tile_gap``), the segments traced
(``segments_gap``) and, in adaptive mode, the pixels traced
(``traced_gap``)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import compare, inputs, scenes
from benchmark.reference import adaptive as ref_adaptive
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer as ref_tracer


@dataclasses.dataclass
class State:
    render: object
    scene: object
    cam: object
    config: object
    files: list  # the input files (``inputs.write_inputs``)


def setup(ctx):
    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.ops.kernels import _build

    if ctx.device.type == "cuda":
        _build.build_all()  # every target at once; a built one is kept
    ctx.note("kernels built or found")
    tr = ctx.traffic
    files = inputs.write_inputs(ctx.config, ctx.files_dir)
    scene, cam = scenes.build(ctx.config, files, tr["width"], tr["height"],
                              ctx.device)
    config = RenderConfig(width=tr["width"], height=tr["height"],
                          samples_per_pixel=tr["spp"],
                          max_depth=tr["max_depth"],
                          mode=RenderMode(tr["mode"]))
    state = State(render_lib.render, scene, cam, config, files)
    ctx.note("input files and scene")
    request(state, inputs.WARM_UP, ctx)
    ctx.note("warm-up render")
    return state


def request(state, i, ctx) -> dict:
    img, stats = state.render(state.scene, state.cam, state.config.replace(
        seed=inputs.request_seed(ctx.seed, i)))
    return {"image": img, "segments": int(stats["segments"]),
            "traced": stats.get("traced_pixels")}


def counts(state) -> dict:
    s = state.scene
    return {"rects": s.n_rects, "spheres": s.n_spheres,
            "triangles": s.n_triangles, "media": s.n_media}


def release(state) -> list:
    return state.files


def check(ctx, kept, files) -> list:
    tr = ctx.traffic
    kw = dict(width=tr["width"], height=tr["height"], spp=tr["spp"],
              max_depth=tr["max_depth"])
    sc = ref_scene.build(ctx.config, files, ctx.device)
    cam = ref_tracer.camera(ctx.config["camera"], tr["width"], tr["height"])
    worst = {}
    for i, record in kept:
        seed = inputs.request_seed(ctx.seed, i)
        if tr["mode"] == "adaptive":
            img, segments, traced = ref_adaptive.render(sc, cam, seed=seed,
                                                        **kw)
        else:
            img, segments = ref_tracer.render(sc, cam, seed=seed, **kw)
        numbers = compare.image(record["image"], img)
        numbers["segments_gap"] = compare.rel_gap(record["segments"],
                                                  segments)
        if tr["mode"] == "adaptive":
            numbers["traced_gap"] = compare.rel_gap(record["traced"], traced)
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
        del img
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return compare.verdict(worst, ctx.cell.workload["limits"])
