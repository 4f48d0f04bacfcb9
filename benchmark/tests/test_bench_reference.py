"""The float64 reference against the port's CPU path (the kernels' plain
versions) at tiny sizes: both configurations in single and adaptive mode,
and the training step.  The port is imported here, never by the
reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, scenes
from benchmark.reference import adaptive, files, rng, train
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
W, H, SPP, DEPTH = 48, 36, 4, 4
# (image_mad, segments_gap) the port's float32 reaches against the float64
# reference.  The Cornell box spans 555 units, where a float32 hit point is
# off by ~3e-5 and a scattered ray whose direction is short re-hits its own
# wall past t_min (1e-3): float32 paths run longer and darker there, in
# every float32 tracer (the reference in float32 too), by up to 2% of the
# segments at depth 50.  The capsule spans 2 units.
CLOSE = {"cornell_box": (0.3, 2e-2), "mesh_capsule": (0.01, 1e-3)}


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_threefry_matches_the_port():
    from another_raytracer_tpu_torch.ops import rng as port_rng

    pix = torch.arange(1000) * 7919 % (1 << 32)
    samp = torch.arange(1000) % 97
    for bounce, dim in ((0, 0), (3, 2), (rng.CAMERA_BOUNCE, 0), (7, 8)):
        ours = rng.uniform2(123456789, pix, samp, bounce, dim, torch.float64)
        port = port_rng.uniform2(123456789, pix, samp, bounce, dim)
        for a, b in zip(ours, port):
            assert torch.equal(a, b.double())


def test_png_and_obj_readers(tmp_path):
    path = inputs.write_capsule(tmp_path, segments=8, rings=6, texels=16)
    mesh = files.read_obj(path)
    assert mesh["pos"].shape == (8 * 6 * 2, 3, 3)
    assert mesh["mtl"]["checker"]["map_kd"] == "checker.png"
    img = files.read_png(tmp_path / "checker.png")
    assert img.shape == (16, 16, 3)
    assert tuple(img[0, 0]) == (230, 200, 40)
    assert tuple(img[0, 2]) == (40, 60, 200)
    from another_raytracer_tpu_torch.models import mesh as port_mesh

    port = port_mesh.parse(path, native=False)
    np.testing.assert_array_equal(port.tri_pos, mesh["pos"])


@pytest.mark.parametrize("name", ["cornell_box", "mesh_capsule"])
@pytest.mark.parametrize("mode", ["single", "adaptive"])
def test_render_matches_the_port(tmp_path, name, mode):
    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
    from another_raytracer_tpu_torch.ops import render as render_lib

    cfg = config(name)
    files = inputs.write_inputs(cfg, tmp_path)
    scene, cam = scenes.build(cfg, files, W, H, "cpu")
    seed = inputs.request_seed(3_000_000_001, 5)
    img, stats = render_lib.render(scene, cam, RenderConfig(
        width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH, seed=seed,
        mode=RenderMode(mode)))
    sc = ref_scene.build(cfg, files, "cpu")
    rcam = tracer.camera(cfg["camera"], W, H)
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH, seed=seed)
    if mode == "adaptive":
        ref, segments, traced = adaptive.render(sc, rcam, **kw)
        assert traced == stats["traced_pixels"]
    else:
        ref, segments = tracer.render(sc, rcam, **kw)
    mad, seg = CLOSE[name]
    assert compare.image(img, ref)["image_mad"] <= mad
    assert compare.rel_gap(stats["segments"], segments) <= seg


def test_train_steps_match_the_port():
    from another_raytracer_tpu_torch.grad import diff

    cfg = config("cornell_box")
    scene, cam = scenes.build(cfg, [], W, H, "cpu")
    target = inputs.target_image(7, W, H, "cpu")
    state, step = diff.make_train_step(
        scene, cam, target, width=W, height=H, spp=SPP, samples_per_pass=1,
        max_depth=DEPTH, learning_rate=cfg["learning_rate"],
        trainable=tuple(cfg["trainable"]))
    start = {k: v.detach().clone() for k, v in state.params.items()}
    seeds = [inputs.request_seed(7, k) for k in (1, 2, 3)]
    losses = []
    for k, s in enumerate(seeds):
        state, loss = step(state, s)
        losses.append(loss.item())
        if k == 0:
            grads = {n: state.opt_state.state[p]["exp_avg"] / 0.1
                     for n, p in state.params.items()}
    sc = ref_scene.build(cfg, [], "cpu")
    leaves = {k: sc.leaves[k] for k in cfg["trainable"]}
    rl, rg, after = train.adam_steps(
        sc, tracer.camera(cfg["camera"], W, H), leaves, target.double(),
        seeds, cfg["learning_rate"], width=W, height=H, spp=SPP,
        max_depth=DEPTH)
    assert compare.rel_gap(losses[0], rl[0]) <= 1e-5
    assert max(compare.rel_gap(p, r) for p, r in zip(losses, rl)) <= 1e-2
    assert compare.leaf_gap(grads, rg) <= 1e-3
    moved = compare.moved_leaves(rg)
    assert sorted(moved) == ["background", "tex_ca"]
    change = {k: state.params[k].detach() - start[k] for k in start}
    assert compare.leaf_gap(change, {k: after[k] - leaves[k]
                                     for k in leaves}, only=moved) <= 1e-2
