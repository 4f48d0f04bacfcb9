"""The two inverse-rendering demos: recover perturbed scene parameters by
gradient descent on a rendered target (the counterpart of the JAX
package's ``scripts/train_demo.py`` and ``scripts/train_demo_atlas.py``,
whose protocols, seeds and pass criteria it keeps).

    python -m another_raytracer_tpu_torch.train_demo [--atlas] [--steps N]
        [--cpu] [--out PATH]

Cornell (default): the Cornell box at 180x135, spp 8, depth 6; its
``tex_ca`` albedos perturbed multiplicatively (``default_rng(0)``, x0.4-1.9,
clamped to [0, 20]) and its background raised by 0.05; adam lr 5e-2 over
``DEFAULT_TRAINABLE`` through ``diff.make_train_step``.  The step runs the
fused path: K2 and the replay backward.

``--atlas``: an image-textured sphere over a grey ground at 180x135, spp
32, depth 4; the texture box-downed to 32x16 texels, every texel perturbed
(x0.2-2.5, +0-0.25, clamped to [0, 1]); adam lr 2e-2, eps 1e-5 over
``("atlas",)``.  Image textures take the lockstep autograd path (the texel
fetch's backward is a scatter-add onto the texel table), which launches no
kernel.  The texture is the reference's earthmap where its assets are
present (``utils.assets``), else the committed 128x64 JPEG sample
``utils/jpeg_samples/baseline_420.jpg``; the record names it.  Recovery is
scored over the well-observed texels: gradient weight at the true texels
>= 10% of the largest.

Both: the target rendered at the true parameters with seed 99, the
Monte-Carlo floor (the loss at the true parameters under seed 555), step k
at seed 1000 + k.  ``--cpu`` runs the scripts' CPU configuration on the
CPU (the kernels' plain versions) and their CPU criteria (final loss < 0.6x
the first, the error reduced); otherwise the card's (final loss < 2x the
floor, the error cut >= 3x).  Both trace one sample of a pixel per pass, as
the scripts do; ``atlas_demo(samples_per_pass=spp)`` traces the same
samples in one pass (the RNG keys on the sample id), summed in another
order.

Runs on the card unless ``--cpu`` is given, and raises when no CUDA device
is visible.  The last line of stdout is a JSON record: the scripts' fields,
the card's name and power limit, the step time, and every kernel's
launches over the training steps (``ops.kernels.launch_counts``).  Exits 1
when the criteria fail.  Writes no file unless ``--out`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import kernels
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.utils import assets, imageio, profiling

# (width, height, spp, max_depth) of each demo; the atlas demo's texels.
CORNELL = {"chip": (180, 135, 8, 6), "cpu": (48, 36, 4, 4)}
ATLAS = {"chip": (180, 135, 32, 4), "cpu": (48, 36, 16, 3)}
ATLAS_TEXELS = {"chip": (32, 16), "cpu": (8, 4)}
STEPS = 400
TARGET_SEED, FLOOR_SEED, OBSERVE_SEED, STEP_SEED = 99, 555, 556, 1000
T_MIN = 1e-3
SAMPLE_JPEG = Path(__file__).parent / "utils" / "jpeg_samples" / \
    "baseline_420.jpg"


@dataclasses.dataclass
class Demo:
    """One demo, set up and ready to step: ``step(k)`` runs adam step k
    (seed 1000 + k) on ``params`` and returns its loss (a tensor).  The
    criteria score |params[leaf] - true| over the rows ``observed``
    selects (every row for Cornell, the well-observed texels for the
    atlas)."""

    name: str
    config: str
    kw: dict
    floor: float
    step: Callable
    params: dict
    leaf: str
    true: np.ndarray
    observed: np.ndarray
    log_every: int
    texture: str = None

    def __post_init__(self):
        self.err0 = self.error()

    def abs_err(self):
        return np.abs(self.params[self.leaf].detach().cpu().numpy()
                      - self.true)

    def error(self):
        return float(self.abs_err()[self.observed].mean())


def box_down(img, fy, fx):
    """Mean over fy x fx blocks of an [h, w, 3] image (the scripts')."""
    h, w = img.shape[:2]
    h2, w2 = h // fy * fy, w // fx * fx
    return img[:h2, :w2].reshape(h2 // fy, fy, w2 // fx, fx, 3).mean((1, 3))


def _target(scene, cam, kw):
    """The averaged radiance at the true parameters, [H*W, 3]."""
    with torch.no_grad():
        acc, _ = render_lib.render_radiance(scene, cam, TARGET_SEED,
                                            differentiable=True, **kw)
    return torch.stack(tuple(acc), dim=1) / kw["spp"]


def cornell_demo(device, cpu=False) -> Demo:
    """``scripts/train_demo.py``'s protocol on ``device``."""
    dev = torch.device(device)
    w, h, spp, depth = CORNELL["cpu" if cpu else "chip"]
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=1,
              max_depth=depth, t_min=T_MIN)
    scene, cam_params = library.cornell_box(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=w / h, device=dev, **cam_params)
    target = _target(scene, cam, kw)
    true_ca = scene.tex_ca.cpu().numpy()
    tparams, _ = diff.split_params(scene)
    floor = float(diff.render_value_and_grad(tparams, scene, cam, target,
                                             FLOOR_SEED, **kw)[0])

    rng = np.random.default_rng(0)
    pert_ca = np.clip(true_ca * rng.uniform(0.4, 1.9, true_ca.shape),
                      0.0, 20.0)
    pscene = scene.replace(
        tex_ca=torch.from_numpy(pert_ca.astype(np.float32)).to(dev),
        background=scene.background + 0.05)
    state, step = diff.make_train_step(pscene, cam, target,
                                       learning_rate=5e-2, **kw)
    return Demo(
        name="cornell",
        config=f"cornell {w}x{h} spp{spp} depth{depth} adam lr=5e-2",
        kw=kw, floor=floor, step=lambda k: step(state, STEP_SEED + k)[1],
        params=state.params, leaf="tex_ca", true=true_ca,
        observed=np.ones(true_ca.shape[0], bool), log_every=10)


def atlas_image():
    """(the texture as [h, w, 3] in [0, 1], its name): the earthmap where
    the reference's assets are present, else the committed JPEG sample."""
    path = assets.earthmap_path()
    name = "earthmap"
    if path is None:
        path, name = SAMPLE_JPEG, "utils/jpeg_samples/baseline_420.jpg"
    return np.asarray(imageio.load_image(path), np.float64), name


def atlas_scene(texels, device):
    """The scripts' earth scene over ``texels`` ([h, w, 3] in [0, 1]): an
    image-textured sphere over a grey ground, sky background."""
    b = SceneBuilder(background=(0.70, 0.80, 1.00), seed=7)
    b.sphere((0, 0, 0), 2.0, b.lambertian(texture=b.image_texture(texels)))
    b.sphere((0, -1002.0, 0), 1000.0, b.lambertian(color=(0.5, 0.5, 0.5)))
    return b.build(device=device)


def atlas_demo(device, cpu=False, samples_per_pass=1, image=None) -> Demo:
    """``scripts/train_demo_atlas.py``'s protocol on ``device``; ``image``
    ([h, w, 3] in [0, 1]) replaces ``atlas_image()``'s texture, and
    ``samples_per_pass`` = spp traces a pixel's samples in one pass."""
    dev = torch.device(device)
    size = "cpu" if cpu else "chip"
    w, h, spp, depth = ATLAS[size]
    tex = ATLAS_TEXELS[size]
    name = "given"
    if image is None:
        image, name = atlas_image()
    small = box_down(image, image.shape[0] // tex[1], image.shape[1] // tex[0])
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=samples_per_pass,
              max_depth=depth, t_min=T_MIN)
    scene = atlas_scene(small, dev)
    cam = camera_lib.make_camera(lookfrom=(0, 0, 12), lookat=(0, 0, 0),
                                 vfov=22.0, aspect_ratio=w / h, device=dev)
    target = _target(scene, cam, kw)
    true_atlas = scene.atlas.cpu().numpy()

    tparams, _ = diff.split_params(scene, ("atlas",))
    floor = float(diff.render_value_and_grad(tparams, scene, cam, target,
                                             FLOOR_SEED, **kw)[0])
    # Texel observability: the gradient weight at the true texels; texels
    # under 10% of the largest weight see only rare secondary bounces.
    g0 = diff.render_value_and_grad(tparams, scene, cam, target,
                                    OBSERVE_SEED, **kw)[1]["atlas"]
    wt = g0.abs().sum(-1).cpu().numpy()

    rng = np.random.default_rng(0)
    pert = np.clip(true_atlas * rng.uniform(0.2, 2.5, true_atlas.shape)
                   + rng.uniform(0.0, 0.25, true_atlas.shape),
                   0.0, 1.0).astype(np.float32)
    pscene = scene.replace(atlas=torch.from_numpy(pert).to(dev))
    state, step = diff.make_train_step(pscene, cam, target, learning_rate=2e-2,
                                       eps=1e-5, trainable=("atlas",), **kw)
    return Demo(
        name="atlas",
        config=(f"earth-sphere {w}x{h} spp{spp} depth{depth} "
                f"tex{small.shape[1]}x{small.shape[0]} adam lr=2e-2 eps=1e-5 "
                f"trainable=atlas"),
        kw=kw, floor=floor, step=lambda k: step(state, STEP_SEED + k)[1],
        params=state.params, leaf="atlas", true=true_atlas,
        observed=wt > 0.1 * wt.max(), log_every=20, texture=name)


def run(demo: Demo, steps: int, cpu: bool, log=print) -> dict:
    """Run ``steps`` adam steps; return the record with ``passed`` and,
    where a criterion failed, ``failed``."""
    before = kernels.launch_counts()
    losses = []
    dev = demo.params[demo.leaf].device
    t0 = time.perf_counter()
    for k in range(steps):
        loss = demo.step(k)
        if k % demo.log_every == 0 or k == steps - 1:
            losses.append((k, float(loss)))
            log(f"step {k:4d}  loss {float(loss):.6f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    after = kernels.launch_counts()

    err1 = demo.error()
    first, final = losses[0][1], losses[-1][1]
    if cpu:
        checks = {"final loss < 0.6 x first loss": final < 0.6 * first,
                  "error reduced": err1 < demo.err0}
    else:
        checks = {"final loss < 2 x floor": final < 2.0 * demo.floor,
                  "error cut >= 3x": err1 * 3.0 <= demo.err0}
    rec = {"config": demo.config, "steps": steps,
           "backend": dev.type, "loss_curve": losses}
    errs = {"perturbed": demo.err0, "recovered": err1}
    if demo.name == "cornell":
        rec["tex_ca_mean_abs_err"] = errs
    else:
        hidden = demo.abs_err()[~demo.observed]
        rec.update({
            "texture": demo.texture,
            "observed_texel_fraction": float(demo.observed.mean()),
            "atlas_mean_abs_err_observed": errs,
            "atlas_mean_abs_err_unobserved_after":
                float(hidden.mean()) if hidden.size else 0.0})
    rec.update({
        "seconds": wall, "ms_per_step": wall / steps * 1e3,
        "mc_noise_floor_at_true_params": demo.floor,
        "samples_per_pass": demo.kw["samples_per_pass"],
        "card": profiling.card_line() if dev.type == "cuda" else None,
        "launches": {k: after[k] - before[k] for k in after
                     if k != "K5_by_tree"},
        "criteria": "cpu" if cpu else "chip",
        "passed": all(checks.values()),
        "failed": [c for c, ok in checks.items() if not ok]})
    log(f"\nloss {first:.6f} -> {final:.6f} (floor {demo.floor:.6f})")
    log(f"mean |error|: {demo.err0:.4f} -> {err1:.4f} "
        f"({demo.err0 / max(err1, 1e-9):.1f}x)")
    log(f"{steps} steps in {wall:.2f} s ({rec['ms_per_step']:.2f} ms/step)")
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--atlas", action="store_true",
                   help="the image-texture demo (default: Cornell)")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--cpu", action="store_true",
                   help="the CPU configuration on the CPU")
    p.add_argument("--out", default=None, help="write the record here")
    args = p.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (use --cpu for the "
                           "CPU configuration on the plain PyTorch versions)")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    make = atlas_demo if args.atlas else cornell_demo
    demo = make(device, cpu=args.cpu)
    rec = run(demo, args.steps, args.cpu)
    print("PASS" if rec["passed"] else f"FAIL: {', '.join(rec['failed'])}")
    line = json.dumps(rec)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if rec["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
