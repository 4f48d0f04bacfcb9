#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``another_raytracer_tpu_torch/csrc`` (one
nvcc per target, in parallel), then drives the main paths of the port and
holds every kernel against its plain PyTorch version:

* serving: threefry words bit for bit, the forward megakernel (K1) against
  its plain version on three scenes, the README render (Cornell 720x540,
  spp 100, depth 50) through the CLI, and K1's time;
* training: the record-mode megakernel (K2) and the replay backward against
  their plain versions at the bench size (Cornell 360x270, spp 16, depth 8),
  the fused gradients against the lockstep autograd path, 24 adam steps of
  the inverse-rendering demo's protocol, and the times of K2, the replay,
  one fwd+bwd step through the kernels, through the plain versions and
  through the lockstep path, and ``python -m another_raytracer_tpu_torch.bench``;
* the wavefront of BVH and texture scenes: the BVH closest-hit kernel (K5)
  against its plain version on ~400k rays over the random scene's sphere
  tree, 10,240 triangles and 128 rects (every fold variant), the Perlin
  kernel (K4) on 1M points, the wavefront through the kernels against the
  same through the plain versions on four scenes, the CLI on scene 1
  (720x540, spp 100, depth 50), a profiler trace of scene 1 at spp 1 (where
  the render's time goes), the CLI on scenes 3, 4 and 5 (spp 16), and the
  two kernels' times beside their bounds;
* the megakernel's accel mode (K3): its forward instance against its plain
  version on scene 1 and an 81-sphere tree, its record instance and the
  replay at scene 1's 485 textures against theirs at the bench size, the
  scene-1 README render through the CLI in single and adaptive mode, fused
  against lockstep gradients on scene 1 at the bench size, the two gate
  measurements (the scene-1 render through K3 and through the wavefront +
  K5; the fused and the lockstep step), and the times of K3's two
  instances and the large-T replay beside their bounds.

The wavefront phases run with ``mega_kernel.MEGA_FORWARD = False``, which
sends scene 1 to the wavefront + K5 (its auto route is K3).  Every phase prints one line with its seconds, and any failure raises
(non-zero exit).  The last three lines are the card's name and power limit
(nvidia-smi), a JSON object describing each kernel, and
``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible or the port
package is not beside this script.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# The bar of tests/test_mega.py:37-45 (kernel vs reference).
FLIP_ABS, FLIP_BUDGET, MEDIAN_MAX = 2e-2, 0.02, 1e-5

W, H, SPP, DEPTH = 720, 540, 100, 50  # README render (serving), scene 1
TEX_SPP = 16  # scenes 3, 4 and 5 through the CLI
CW, CH, CSPP = 180, 135, 4  # the wavefront comparison
BW, BH, BSPP, BDEPTH = 360, 270, 16, 8  # bench.py (training)
TW, TH, TSPP, TDEPTH = 180, 135, 8, 6  # scripts/train_demo.py, chip size
TRAIN_STEPS = 24
K1_PR1_MS = 18.596  # K1 alone, README render (PERF.md, H100 80GB HBM3, 700 W)
SRC = "another_raytracer_tpu_torch/csrc/"
JAX_PALLAS = "another_raytracer_tpu/ops/pallas/"

# Published peaks of one H100 SXM at 700 W: fp32 outside the tensor cores,
# and device memory.  A kernel's bound
# is the larger of its operations over the first and its bytes over the
# second; integer operations are counted at the fp32 rate.
PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12
# Operations per ray segment of K1 and K2, counted from csrc/mega_kernel.cu:
# a sphere row's test, a rect row's test, and the rest of a segment (one
# 13-round threefry call, direction sampling, shading, carry updates).
OPS_SPHERE_ROW, OPS_RECT_ROW, OPS_SEGMENT = 30, 35, 144
# K3 per segment: OPS_SEGMENT, the winner's normal (9), and the walk's slab
# and sphere tests (ops/bvh.py's OPS_PER_SLAB, OPS_PER_TEST), counted by the
# plain version on the same inputs.
OPS_K3_NORMAL = 9
# Operations per residual row of the replay, and per point of K4
# (csrc/mega_replay.cu, csrc/perlin_kernel.cu).
OPS_REPLAY_ROW, OPS_PERLIN = 15, 96

_T_LAST = [time.perf_counter()]


def phase(name, line):
    now = time.perf_counter()
    print(f"[{name}] ({now - _T_LAST[0]:.1f} s) {line}", flush=True)
    _T_LAST[0] = now


def bound(ops, nbytes):
    """(least milliseconds, "operations" or "bytes") at the card's peaks."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def metal_scene(device):
    """Lens + motion + metal + dielectric + checker (tests/test_mega.py:53-66)."""
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(device=device), cam


def many_textures_scene(device):
    """A sweep scene with 21 solid textures (> 16: the JAX replay's
    gather/scatter branch): 20 small spheres, each with its own colour, on
    a large one."""
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    rng = np.random.default_rng(9)
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -1000, 0), 1000, b.lambertian(color=(0.5, 0.5, 0.5)))
    for _ in range(20):
        c = (rng.uniform(-3, 3), rng.uniform(0.2, 0.5), rng.uniform(-3, 1))
        b.sphere(c, 0.3, b.lambertian(color=tuple(rng.uniform(0.1, 0.9, 3))))
    cam = dict(lookfrom=(6, 2, 3), lookat=(0, 0.3, -1), vfov=30.0)
    return b.build(device=device), cam


def lanes(width, height, device):
    import torch

    n = width * height
    return (torch.arange(n, dtype=torch.int64, device=device),
            torch.zeros(n, dtype=torch.int64, device=device))


def forward_bar(got, ref, got_segs, ref_segs, what):
    """Raise unless radiance and segments are within the bar; returns stats."""
    from another_raytracer_tpu_torch.ops import vec3

    got, ref = vec3.to_numpy(got), vec3.to_numpy(ref)
    got_segs, ref_segs = int(got_segs), int(ref_segs)
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: kernel radiance has non-finite values")
    diff = np.abs(got - ref)
    stats = dict(segments=got_segs, segments_plain=ref_segs,
                 max_abs_err=float(diff.max()),
                 median_abs_err=float(np.median(diff)),
                 frac_over=float((diff > FLIP_ABS).mean()))
    if abs(got_segs - ref_segs) > max(4, 0.01 * ref_segs):
        raise AssertionError(f"{what}: segment drift too large: {stats}")
    if stats["frac_over"] > FLIP_BUDGET or stats["median_abs_err"] >= MEDIAN_MAX:
        raise AssertionError(f"{what}: radiance disagrees beyond the bar: {stats}")
    return stats


def bvh_sphere_scene(device):
    """81 spheres in one tree (tests/test_mega.py:74-95): checker ground,
    lambertian / metal / dielectric, one moving sphere."""
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=9)
    b.sphere((0, -1000, 0), 1000, b.lambertian(
        texture=b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    rnd = np.random.default_rng(4)
    for i in range(80):
        c = (rnd.uniform(-6, 6), 0.3, rnd.uniform(-8, -1))
        k = i % 4
        if k == 0:
            m = b.lambertian(color=tuple(rnd.uniform(0.2, 0.9, 3)))
        elif k == 1:
            m = b.metal(tuple(rnd.uniform(0.5, 1.0, 3)), rnd.uniform(0, 0.4))
        elif k == 2:
            m = b.dielectric(1.5)
        else:
            m = b.lambertian(color=(0.8, 0.4, 0.2))
        b.sphere(c, 0.3, m)
    b.moving_sphere((0, 0.5, -3), (0, 0.8, -3), 0, 1, 0.3,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 1.5, 3), lookat=(0, 0, -4), vfov=50.0,
               time0=0.0, time1=1.0)
    return b.build(device=device, sphere_bvh=True), cam


def compare(scene, cam_params, width, height, spp, depth, device, seed=3,
            what="K1"):
    """The megakernel (K1, or K3 on a sphere tree) vs its plain version on
    the same lanes; raises unless within bar."""
    import torch

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    cam = camera_lib.make_camera(aspect_ratio=width / height, device=device,
                                 **cam_params)
    pix, samp = lanes(width, height, device)
    kw = dict(width=width, height=height, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=depth, t_min=1e-3)
    got, got_segs = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp, seed, **kw)
    ref, ref_segs = mega_kernel.trace_regenerative_mega_reference(
        scene, cam, pix, samp, seed, **kw)
    torch.cuda.synchronize(device)
    return forward_bar(got, ref, got_segs, ref_segs, what)


def compare_record(scene, cam_params, device, seed=0, what="K2"):
    """The record instance (K2, or K3's on a sphere tree) vs its plain
    version at the bench size: the forward bar, codes equal on >= 98% of
    lanes (event and end bit on every row; texture id and checker bit where
    the event is a scatter or a light hit), and tprev within 1e-5 on equal
    lanes.  Returns (stats, the kernel's outputs, cam)."""
    import torch

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    cam = camera_lib.make_camera(aspect_ratio=BW / BH, device=device,
                                 **cam_params)
    pix, samp = lanes(BW, BH, device)
    kw = dict(width=BW, height=BH, sample_stride=1, sample_end=BSPP,
              spp_cap=BSPP, max_depth=BDEPTH, t_min=1e-3,
              record_iters=BSPP * BDEPTH)
    got = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, seed, **kw)
    ref = mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp,
                                                        seed, **kw)
    torch.cuda.synchronize(device)
    stats = forward_bar(got[0], ref[0], got[1], ref[1], what)
    c, rc = got[2], ref[2]
    ev_end = ((c & 7) == (rc & 7)).all(dim=0)
    live = ((rc & 3) == 1) | ((rc & 3) == 2)
    tid_odd = torch.where(live, (c >> 3) == (rc >> 3), True).all(dim=0)
    equal = ev_end & tid_odd
    frac = float(equal.float().mean())
    tp_err = max(float((a - b)[:, equal].abs().max()) for a, b in zip(got[3], ref[3]))
    bit_equal = all(torch.equal(a, b) for a, b in zip(
        (*got[0], got[2], *got[3]), (*ref[0], ref[2], *ref[3])))
    stats.update(lanes_codes_equal=frac, tprev_max_err_equal_lanes=tp_err,
                 bit_equal=bit_equal)
    if frac < 0.98 or tp_err > 1e-5:
        raise AssertionError(f"{what} residual rows disagree: {stats}")
    return stats, got, cam


def compare_replay(scene, got, device):
    """The replay kernel vs its plain version on K2's own residuals, with a
    positive random cotangent; gradients to rtol 1e-5."""
    import torch

    from another_raytracer_tpu_torch.ops.kernels import mega_diff
    from another_raytracer_tpu_torch.ops.vec3 import V3

    gen = torch.Generator(device=device).manual_seed(1)
    B = got[2].shape[1]
    ghat = V3(*(torch.rand(B, generator=gen, device=device) * 0.8 + 0.2
                for _ in range(3)))
    args = (got[2], got[3], ghat, scene.tex_ca, scene.tex_cb,
            scene.background, mega_diff._flags(scene))
    kern = mega_diff.replay_backward(*args)
    plain = mega_diff.replay_backward_reference(*args)
    torch.cuda.synchronize(device)
    err = 0.0
    for name, a, b in zip(("tex_ca", "tex_cb", "background"), kern, plain):
        bad = (a - b).abs() > 1e-5 * b.abs() + 1e-30
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"replay {name}: kernel {a.tolist()} vs "
                                 f"plain {b.tolist()}")
        err = max(err, float((a - b).abs().max()))
    return dict(textures=scene.tex_ca.shape[0], max_abs_err=err,
                grad_tex_ca_max=float(plain[0].abs().max())), (args, ghat)


def fused_vs_lockstep(scene, cam, target, params, kw, dev, seed=555):
    """Gradients of the demo loss (render_value_and_grad of ``params``
    against ``target``) through the fused path (the kernels) and the
    lockstep autograd path.  Returns (loss rel diff, {leaf: gradient rel
    L2}) on all pixels, the same without the pixels whose paths differ
    between the two routes, and the number of those pixels."""
    import torch

    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.ops import render as render_lib

    trainable = tuple(sorted(params))
    spp = kw["spp"]
    # The two routes' float arithmetic flips a few paths.  Find the pixels
    # where a path differs: render both routes with every texture and the
    # background recoloured (colours steer no path, and with a lit background
    # every path that reaches a light or escapes shows in the radiance), and
    # drop the pixels whose radiance differs beyond float rounding.
    fp = scene.replace(
        tex_ca=scene.tex_ca * torch.as_tensor(
            np.random.default_rng(3).uniform(0.5, 1.5, tuple(scene.tex_ca.shape)),
            dtype=torch.float32, device=dev),
        background=torch.tensor([0.3, 0.5, 0.7], device=dev))

    def images(sc):
        out = []
        for flag in (None, False):
            with fused(flag), torch.no_grad():
                a, _ = render_lib.render_radiance(sc, cam, seed,
                                                  differentiable=True,
                                                  trainable=trainable, **kw)
            out.append(torch.stack(tuple(a), dim=1) / spp)
        return out

    def differ(a, b, rtol):
        return ((a - b).abs() > rtol * torch.maximum(a.abs(), b.abs())
                + 1e-2 * rtol).any(dim=1)

    # Where paths agree, the two routes' radiance agrees to float rounding
    # (~1e-7); a flip deep in a path moves a pixel by as little as ~1e-4 of
    # its value, and the recolouring may shrink that, so flips are found at
    # 1e-6.
    flipped = differ(*images(fp), 1e-6)
    img_f, img_l = images(scene)
    if bool((differ(img_f, img_l, 1e-4) & ~flipped).any()):
        raise AssertionError("the image differs on a pixel whose paths agree")
    n_flipped = int(flipped.sum())
    if n_flipped > FLIP_BUDGET * flipped.numel():
        raise AssertionError(f"{n_flipped} of {flipped.numel()} pixels flipped")

    def value_and_grads(flag, tgt):
        with fused(flag):
            return diff.render_value_and_grad(params, scene, cam, tgt, seed,
                                              **kw)

    def agreement(res_f, res_l):
        (loss_f, g_f), (loss_l, g_l) = res_f, res_l
        return (abs(float(loss_f) - float(loss_l)) / abs(float(loss_l)),
                {k: rel_l2(g_f[k], g_l[k]) for k in g_f})

    # The loss as is, then with the flipped pixels dropped: there each
    # route's target is its own image, so the pixel adds no loss and no
    # gradient on either route.
    loss_all, errs_all = agreement(value_and_grads(None, target),
                                   value_and_grads(False, target))
    loss_rel, errs = agreement(
        value_and_grads(None, torch.where(flipped[:, None], img_f, target)),
        value_and_grads(False, torch.where(flipped[:, None], img_l, target)))
    return loss_all, errs_all, loss_rel, errs, n_flipped


def rel_l2(a, b):
    na, nb = float((a - b).norm()), float(b.norm())
    return 0.0 if na == 0.0 else na / max(nb, 1e-30)


@contextlib.contextmanager
def plain_versions():
    """Run the fused path through the two kernels' plain versions (on the
    card), for timing the step they replace."""
    from another_raytracer_tpu_torch.ops.kernels import mega_diff, mega_kernel

    saved = mega_kernel.trace_regenerative_mega, mega_diff.replay_backward
    mega_kernel.trace_regenerative_mega = (
        mega_kernel.trace_regenerative_mega_reference)
    mega_diff.replay_backward = mega_diff.replay_backward_reference
    try:
        yield
    finally:
        mega_kernel.trace_regenerative_mega, mega_diff.replay_backward = saved


@contextlib.contextmanager
def fused(flag):
    from another_raytracer_tpu_torch.ops.kernels import mega_diff

    saved = mega_diff.FUSED_DIFF
    mega_diff.FUSED_DIFF = flag
    try:
        yield
    finally:
        mega_diff.FUSED_DIFF = saved


@contextlib.contextmanager
def mega_forward(flag):
    """Set mega_kernel.MEGA_FORWARD (False: forward renders take the
    wavefront), restored after."""
    from another_raytracer_tpu_torch.ops.kernels import mega_kernel

    saved = mega_kernel.MEGA_FORWARD
    mega_kernel.MEGA_FORWARD = flag
    try:
        yield
    finally:
        mega_kernel.MEGA_FORWARD = saved


def cuda_ms(fn, dev, runs):
    """Median of ``runs`` CUDA-event timings of fn() after a warm-up call."""
    import torch

    fn()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize(dev)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize(dev)
        out.append(a.elapsed_time(b))
    return float(np.median(out)), [round(x, 3) for x in out]


def kernel_usage(log, name):
    """(registers, spilled bytes) of the kernel whose mangled name holds
    ``name``, from a ``-Xptxas -v`` build report."""
    current, regs, spilled = "", None, 0
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)", ln)
        if m:
            current = m.group(1)
        elif name in current:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spilled += int(m.group(1)) + int(m.group(2)) if m else 0
            m = re.search(r"Used (\d+) registers", ln)
            regs = int(m.group(1)) if m else regs
    if regs is None:
        raise AssertionError(f"no kernel {name} in the build report")
    return regs, spilled


def bare(run):
    """A bare ctypes launch that must succeed."""
    def go():
        err = run()
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return go


# --------------------------------------------------------------------------
# The wavefront of BVH and texture scenes: K5 and K4
# --------------------------------------------------------------------------


def sheet_scene(device):
    """The 128-triangle bumpy sheet of __graft_entry__.py:36-60 in a BVH,
    with a barycentric texture and an image texture of generated texels on
    alternate cells, and a light above it."""
    import math

    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0))
    texels = np.random.default_rng(4).uniform(0, 1, (6, 9, 3))
    mats = (b.lambertian(texture=b.barycentric_texture((1, 0, 0), (0, 1, 0),
                                                       (0, 0, 1))),
            b.lambertian(texture=b.image_texture(texels)))
    n = 8
    for i in range(n):
        for j in range(n):
            def pt(ii, jj):
                x = -1.0 + 2.0 * ii / n
                z = -2.0 - 2.0 * jj / n
                return (x, 0.15 * math.sin(3.0 * x + 2.0 * z), z)

            uv = ((i / n, j / n), ((i + 1) / n, j / n),
                  ((i + 1) / n, (j + 1) / n))
            p00, p10, p01, p11 = pt(i, j), pt(i + 1, j), pt(i, j + 1), pt(i + 1, j + 1)
            b.triangle(p00, p10, p11, mats[(i + j) % 2], uvs=uv)
            b.triangle(p00, p11, p01, mats[(i + j) % 2], uvs=uv)
    b.xz_rect(-2, 2, -4, 0, 2.5, b.diffuse_light(color=(3, 3, 3)))
    cam = dict(lookfrom=(0, 1.2, 1.0), lookat=(0, 0, -3), vfov=55.0)
    return b.build(device=device, bvh=True), cam


def shell_rays(rng, n, radius, spread, center=(0.0, 0.0, 0.0)):
    """Rays from a shell around the primitives toward points among them."""
    u = rng.normal(size=(3, n))
    o = u / np.linalg.norm(u, axis=0) * radius
    d = (rng.uniform(-spread, spread, (3, n)) - o) * rng.uniform(0.5, 2.0, n)
    return ((o + np.asarray(center)[:, None]).astype(np.float32),
            d.astype(np.float32))


def k5_cases(dev, scene1, cam1):
    """The inputs of the K5 comparisons: (name, nodes, rows, o, d, time,
    leaf_size, prim) for the random scene's sphere tree (scene 1's camera
    rays at the main path's width, half of them swapped for random rays in
    the scene), 10,240 random triangles in a planar tree and 128 identity
    rects in a rect tree (rays from a shell around each)."""
    import torch

    from another_raytracer_tpu_torch.models import bvh as bvh_lib
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    pix, samp = lanes(W, H, dev)
    o, d, tm = camera_lib.generate_rays(cam, pix, samp, W, H, 0)
    n = W * H
    half = n // 2
    ro = rng.uniform((-11, 0, -11), (11, 2, 11), (n - half, 3)).T
    rd = rng.normal(size=(3, n - half))
    o = [torch.cat([c[:half], t(r.astype(np.float32))]) for c, r in zip(o, ro)]
    d = [torch.cat([c[:half], t(r.astype(np.float32))]) for c, r in zip(d, rd)]
    tm = torch.cat([tm[:half], t(rng.uniform(0, 1, n - half).astype(np.float32))])
    cases = [("random scene sphere tree", scene1.sph_bvh_nodes,
              scene1.sph_bvh_rows, o, d, tm, scene1.bvh_leaf_size, "sphere")]

    nt = 10240
    base = rng.uniform(-20, 20, (nt, 3))
    v = [base] + [base + rng.uniform(-1.0, 1.0, (nt, 3)) for _ in range(2)]
    uvs = [rng.uniform(0, 1, (nt, 2)) for _ in range(3)]
    tree = bvh_lib.build(*bvh_lib.triangle_bounds(*v), leaf_size=16)
    nodes, rows = bvh_kernel.pack_planar(
        tree, *v, np.arange(nt) * 4 + 2, uv0=uvs[0], uv1=uvs[1], uv2=uvs[2],
        mats=rng.integers(0, 8, nt))
    o, d = shell_rays(rng, n, 40.0, 20.0)
    cases.append((f"{nt} triangles", t(nodes), t(rows), [t(c) for c in o],
                  [t(c) for c in d], torch.zeros(n, device=dev), 16, "planar"))

    nr = 128
    axis = rng.integers(0, 3, nr)
    lo = rng.uniform(-8, 6, (nr, 2))
    hi = lo + rng.uniform(0.5, 2.0, (nr, 2))
    k = rng.uniform(-8, 8, nr)
    tree = bvh_lib.build(*bvh_lib.rect_bounds(axis, k, lo, hi), leaf_size=16)
    nodes, rows = bvh_kernel.pack_rects(tree, axis, k, lo, hi,
                                        np.arange(nr) * 4 + 1)
    o, d = shell_rays(rng, n, 16.0, 8.0)
    cases.append((f"{nr} rects", t(nodes), t(rows), [t(c) for c in o],
                  [t(c) for c in d], torch.zeros(n, device=dev), 16, "rect"))
    return cases


# (prim, fold_record, fold_full, precomp) variants per tree kind.
K5_VARIANTS = {
    "sphere": [(False, False, False), (True, False, False)],
    "planar": [(False, False, False), (False, False, True),
               (True, False, False), (True, False, True),
               (True, True, False), (True, True, True)],
    "rect": [(False, False, False)],
}


def k5_args(case, dev):
    import torch

    from another_raytracer_tpu_torch.ops.vec3 import V3

    _, nodes, rows, o, d, tm, leaf, prim = case
    n = o[0].shape[0]
    return ((nodes, rows, V3(*o), V3(*d), torch.full((n,), 3e37, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev)),
            dict(leaf_size=leaf, prim=prim, time=tm))


def flat_out(out):
    """A K5 result as a flat list of tensors (V3 components spread)."""
    from another_raytracer_tpu_torch.ops.vec3 import V3

    return [x for v in out for x in (v if isinstance(v, V3) else (v,))]


def compare_k5(case, fold, full, pre, dev):
    """K5 vs its plain version on one case and variant.  Bit-equal is the
    expectation (both round every operation alike); otherwise the
    test_mega bar on the lanes (<= 2% of lanes with another winner, median
    |t| difference < 1e-5).  Fold outputs are compared on hit lanes."""
    import torch

    from another_raytracer_tpu_torch.ops import bvh as bvh_ops
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    args, kw = k5_args(case, dev)
    kw.update(fold_record=fold, fold_full=full, precomp=pre)
    got = bvh_kernel.bvh_closest_hit(*args, **kw)
    tm = kw.pop("time")
    want = bvh_ops.traverse_packed(*args[:4], tm, 1e-3, *args[4:], **kw)
    torch.cuda.synchronize(dev)
    g, w = flat_out(got), flat_out(want)
    same = (g[2] == w[2]) & (g[1] == w[1])
    hit = w[2] & same
    bit_equal = all(torch.equal(a, b) for a, b in zip(g, w))
    t_err = float((g[0] - w[0])[same].abs().max())
    aux_err = max([float((a - b)[hit].abs().max()) for a, b in zip(g[3:], w[3:])]
                  or [0.0])
    stats = dict(variant=f"{case[7]} fold={int(fold)} full={int(full)} "
                 f"precomp={int(pre)}", rays=int(g[0].shape[0]),
                 hits=int(w[2].sum()), bit_equal=bit_equal,
                 lanes_differ=int((~same).sum()), max_abs_err_t=t_err,
                 max_abs_err_fold=aux_err)
    diff = (g[0] - w[0])[same].abs()
    if not bit_equal and (float((~same).float().mean()) > FLIP_BUDGET
                          or float(diff.median()) >= MEDIAN_MAX):
        raise AssertionError(f"K5 disagrees with its plain version: {stats}")
    if not 0 < stats["hits"] < stats["rays"]:
        raise AssertionError(f"K5 comparison has no hits or no misses: {stats}")
    return stats


def plain_k5(nodes, rows, o, d, init_t, init_idx, *, leaf_size, t_min=1e-3,
             prim="planar", time=None, fold_record=False, fold_full=False,
             precomp=False):
    """K5's plain version behind the wrapper's signature."""
    from another_raytracer_tpu_torch.ops import bvh as bvh_ops

    return bvh_ops.traverse_packed(
        nodes, rows, o, d, time, t_min, init_t, init_idx, leaf_size=leaf_size,
        prim=prim, fold_record=fold_record, fold_full=fold_full,
        precomp=precomp)


@contextlib.contextmanager
def plain_wavefront():
    """Run the wavefront's bounces through K5's and K4's plain versions (on
    the card)."""
    from another_raytracer_tpu_torch.ops import shade
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel, perlin_kernel

    saved = bvh_kernel.bvh_closest_hit, perlin_kernel.perlin_noise
    bvh_kernel.bvh_closest_hit = plain_k5
    perlin_kernel.perlin_noise = shade.perlin_noise
    try:
        yield
    finally:
        bvh_kernel.bvh_closest_hit, perlin_kernel.perlin_noise = saved


def reset_counts():
    """Every kernel's launch count to 0."""
    from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel, mega_diff,
                                                         mega_kernel,
                                                         perlin_kernel)

    mega_kernel.trace_regenerative_mega.launches = 0
    mega_kernel.trace_regenerative_mega.record_launches = 0
    mega_kernel.trace_regenerative_mega.accel_launches = 0
    mega_kernel.trace_regenerative_mega.accel_record_launches = 0
    mega_diff.replay_backward.launches = 0
    bvh_kernel.bvh_closest_hit.launches = 0
    perlin_kernel.perlin_noise.launches = 0


def counts():
    from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel, mega_diff,
                                                         mega_kernel,
                                                         perlin_kernel)

    return dict(K1=mega_kernel.trace_regenerative_mega.launches,
                K2=mega_kernel.trace_regenerative_mega.record_launches,
                K3=mega_kernel.trace_regenerative_mega.accel_launches,
                K3_record=mega_kernel.trace_regenerative_mega.accel_record_launches,
                replay=mega_diff.replay_backward.launches,
                K5=bvh_kernel.bvh_closest_hit.launches,
                K4=perlin_kernel.perlin_noise.launches)


def run_cli(scene, width, height, spp, depth, tmp, mode="single"):
    """The CLI on the card; returns (rc, stdout, image, {kernel: launches in
    this run})."""
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.utils import imageio

    out = os.path.join(tmp, f"scene{scene}_{mode}.png")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--scene", str(scene), "--width", str(width),
                       "--height", str(height), "--spp", str(spp),
                       "--max-depth", str(depth), "--mode", mode,
                       "--device", "cuda", "--out", out])
    launched = counts()
    return rc, buf.getvalue(), imageio.load_png(out), launched


def cli_stats(stdout):
    m = re.search(r"finished in (\d+) ms \(([\d.]+) Mrays/s, (\d+) segments\)",
                  stdout)
    if m is None:
        raise AssertionError(f"no timing line in the CLI output:\n{stdout}")
    return int(m.group(1)), float(m.group(2)), int(m.group(3))


def profile_render(scene, cam_params, spp, dev):
    """Where one render's time goes: ``render.render_radiance`` of ``scene``
    at W x H, ``spp``, depth DEPTH, once bare on the host clock and once
    under ``torch.profiler``.  Returns (wall ms, device busy ms, device
    kernels, {kernel: launches}, [(device op, ms, calls)] by device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam_params)
    kw = dict(width=W, height=H, spp=spp, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)
    torch.cuda.synchronize(dev)
    reset_counts()
    t = time.perf_counter()
    render_lib.render_radiance(scene, cam, 0, **kw)
    torch.cuda.synchronize(dev)
    wall_ms = (time.perf_counter() - t) * 1e3
    launched = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_lib.render_radiance(scene, cam, 0, **kw)
        torch.cuda.synchronize(dev)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void ", "", e.name)[:72]
            ms, calls = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    if busy_ms <= 0:
        raise AssertionError("the profiler recorded no device activity")
    top = sorted(((nm, ms, c) for nm, (ms, c) in by_name.items()),
                 key=lambda x: -x[1])
    return (wall_ms, busy_ms, sum(c for _, _, c in top), launched, top)


def kernel_entries(log):
    """[(mangled kernel name, registers, spilled bytes)] of a -Xptxas -v
    build report."""
    names = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '?([\w$]+)", ln)
        if m:
            names.append(m.group(1))
    return [(nm,) + kernel_usage(log, nm) for nm in dict.fromkeys(names)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.models import scene as scene_lib
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.ops import rng
    from another_raytracer_tpu_torch.ops.kernels import (_build, mega_diff,
                                                         mega_kernel)
    from another_raytracer_tpu_torch.utils import imageio

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build every target from the checkout's sources, in parallel.
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (path, secs) in built.items():
        usage = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{path.name} in {secs:.1f} s: " + " | ".join(usage))
    phase("build", f"all targets in {time.perf_counter() - t0:.1f} s")
    # The template instances: sweep (ILb0E: K1, K2) and accel (ILb1E: K3).
    k1_regs, k1_spilled = kernel_usage(_build.build_log("mega_kernel"),
                                       "mega_forward_kernelILb0E")
    k2_regs, _ = kernel_usage(_build.build_log("mega_kernel_record"),
                              "mega_forward_kernelILb0E")
    k3_regs, k3_spilled = kernel_usage(_build.build_log("mega_kernel"),
                                       "mega_forward_kernelILb1E")
    k3r_regs, _ = kernel_usage(_build.build_log("mega_kernel_record"),
                               "mega_forward_kernelILb1E")
    if k1_spilled or k3_spilled:
        raise AssertionError("a forward instance of the megakernel spills "
                             "registers")
    phase("build", f"megakernel registers: K1 {k1_regs}, K2 {k2_regs}, K3 "
          f"forward {k3_regs}, K3 record {k3r_regs}")
    for target in ("bvh_kernel", "perlin_kernel"):
        entries = kernel_entries(_build.build_log(target))
        if not entries:
            raise AssertionError(f"no kernel in {target}'s build report")
        phase("build", f"{target}: " + "; ".join(
            f"{nm}: {regs} registers, {spill} bytes spilled"
            for nm, regs, spill in entries))

    # 2. Threefry words on the card: CUDA vs the port's torch threefry.
    n = 1 << 20
    g = torch.Generator(device="cpu").manual_seed(0)
    pixel = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    sample = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    checked = 0
    for seed, bounce, dim in [(7, 0, 0), (0xDEADBEEF, 3, 2),
                              (12345, rng.CAMERA_BOUNCE, rng.DIM_TIME)]:
        key1 = (bounce << 8) | dim
        (w0, w1), (u0, u1) = mega_kernel.threefry_words_cuda(seed, key1, pixel, sample)
        r0, r1 = rng.threefry2x32(seed, key1, pixel, sample, rounds=rng.ROUNDS)
        v0, v1 = rng.uniform2(seed, pixel, sample, bounce, dim)
        if not (torch.equal(w0, r0) and torch.equal(w1, r1)):
            raise AssertionError(f"threefry words differ (seed={seed}, key1={key1})")
        if not (torch.equal(u0.view(torch.int32), v0.view(torch.int32))
                and torch.equal(u1.view(torch.int32), v1.view(torch.int32))):
            raise AssertionError(f"uniform2 bits differ (seed={seed}, key1={key1})")
        checked += n
    phase("threefry", f"{checked} counters bit-exact (words and uniforms)")

    # 3. K1 vs plain version on the card (depth 50, spp 4).
    cornell, cornell_cam = library.cornell_box(device=dev)
    results = {}
    for name, (scene, cam_params) in [
            ("cornell", (cornell, cornell_cam)),
            ("two_spheres", library.two_spheres(device=dev)),
            ("lens_motion_metal_dielectric_checker", metal_scene(dev))]:
        st = compare(scene, cam_params, W, H, 4, DEPTH, dev)
        results[name] = st
        phase("compare_k1", f"{name} {W}x{H} spp4 depth{DEPTH}: {json.dumps(st)}")

    # 4. Serving main path: the CLI, exactly as a user runs it.
    mega_kernel.trace_regenerative_mega.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--scene", "6", "--width", str(W), "--height", str(H),
                           "--spp", str(SPP), "--max-depth", str(DEPTH),
                           "--mode", "single", "--device", "cuda", "--out", out])
        k1_launches = mega_kernel.trace_regenerative_mega.launches
        cli_out = buf.getvalue()
        img = imageio.load_png(out)
    segs = int(re.search(r"(\d+) segments", cli_out).group(1))
    if rc != 0 or k1_launches < 1 or segs <= 0:
        raise AssertionError(f"main path: rc={rc} launches={k1_launches} "
                             f"segments={segs}\n{cli_out}")
    if img.shape != (H, W, 3) or img.mean() < 10.0:
        raise AssertionError(f"main path image is wrong: shape {img.shape}, "
                             f"mean {img.mean():.2f}")
    phase("main_path_serving", f"{cli_out.strip().splitlines()[-2]}; K1 "
          f"launches {k1_launches}; PNG {img.shape} mean {img.mean():.2f}")

    # 5. K1 timing at the README size: alone (bare launch) and through its
    # wrapper, median of 5 each; the plain version once.
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    pix, samp = lanes(W, H, dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    run, _ = mega_kernel.prepare_launch(cornell, cam, pix, samp, 0, **kw)
    k1_ms, k1_runs = cuda_ms(bare(run), dev, 5)
    k1_wrap_ms, _ = cuda_ms(lambda: mega_kernel.trace_regenerative_mega(
        cornell, cam, pix, samp, 0, **kw), dev, 5)
    _, segs_k = mega_kernel.trace_regenerative_mega(cornell, cam, pix, samp, 0, **kw)
    segs_k = int(segs_k)
    t = time.perf_counter()
    torch.cuda.synchronize(dev)
    _, segs_p = mega_kernel.trace_regenerative_mega_reference(
        cornell, cam, pix, samp, 0, **kw)
    torch.cuda.synchronize(dev)
    k1_plain_ms = (time.perf_counter() - t) * 1e3
    phase("timing_k1", f"cornell {W}x{H} spp{SPP} depth{DEPTH}: K1 alone "
          f"{k1_ms:.3f} ms (runs {k1_runs}; {100 * (k1_ms / K1_PR1_MS - 1):+.1f}% "
          f"vs {K1_PR1_MS} ms), {k1_regs} registers, no spills; through its "
          f"wrapper {k1_wrap_ms:.3f} ms; {segs_k} segments, "
          f"{segs_k / k1_ms / 1e3:.1f} Mrays/s; plain {k1_plain_ms:.1f} ms, "
          f"{int(segs_p)} segments")

    # 6. K2 vs its plain version at the bench size.
    rec = {}
    for name, (scene, cam_params) in [
            ("cornell", (cornell, cornell_cam)),
            ("lens_motion_metal_dielectric_checker", metal_scene(dev))]:
        st, got, bcam = compare_record(scene, cam_params, dev)
        rec[name] = (st, got, bcam, scene)
        phase("compare_k2", f"{name} {BW}x{BH} spp{BSPP} depth{BDEPTH}: "
              f"{json.dumps(st)}")

    # 7. The replay vs its plain version on K2's own residuals.
    replay_stats, (replay_args, _) = compare_replay(cornell, rec["cornell"][1], dev)
    phase("compare_replay", f"cornell (T <= 16): {json.dumps(replay_stats)}")
    big, big_cam = many_textures_scene(dev)
    _, got_big, _ = compare_record(big, big_cam, dev)
    st_big, _ = compare_replay(big, got_big, dev)
    phase("compare_replay", f"{st_big['textures']} solid textures (T > 16): "
          f"{json.dumps(st_big)}")

    # 8. The slice end to end: fused (kernels) vs lockstep autograd at the
    # inverse-rendering demo's chip size, then the training main path.
    tcam = camera_lib.make_camera(aspect_ratio=TW / TH, device=dev, **cornell_cam)
    tkw = dict(width=TW, height=TH, spp=TSPP, samples_per_pass=1,
               max_depth=TDEPTH, t_min=1e-3)
    with torch.no_grad():
        acc, _ = render_lib.render_radiance(cornell, tcam, 99,
                                            differentiable=True, **tkw)
    target = torch.stack(tuple(acc), dim=1) / TSPP
    params, _ = diff.split_params(cornell)
    loss_all, errs_all, loss_rel, errs, n_flipped = fused_vs_lockstep(
        cornell, tcam, target, params, tkw, dev)
    phase("e2e_grads", f"cornell {TW}x{TH} spp{TSPP} depth{TDEPTH}, demo target, "
          f"fused vs lockstep: all pixels loss rel {loss_all:.2e}, gradient rel "
          f"L2 {json.dumps(errs_all)}; without the {n_flipped} of "
          f"{TW * TH} pixels whose paths differ: loss rel "
          f"{loss_rel:.2e}, gradient rel L2 {json.dumps(errs)}")
    if loss_rel > 1e-3 or max(errs.values()) > 1e-2:
        raise AssertionError("fused and lockstep gradients disagree")

    true_ca = cornell.tex_ca.clone()
    pert = np.random.default_rng(0).uniform(0.4, 1.9, tuple(true_ca.shape))
    pscene = cornell.replace(
        tex_ca=torch.clamp(true_ca * torch.as_tensor(pert, dtype=torch.float32,
                                                     device=dev), 0.0, 20.0),
        background=cornell.background + 0.05)
    state, step = diff.make_train_step(pscene, tcam, target, learning_rate=5e-2,
                                       **tkw)
    err0 = float((state.params["tex_ca"].detach() - true_ca).abs().mean())
    mega_kernel.trace_regenerative_mega.record_launches = 0
    mega_diff.replay_backward.launches = 0
    losses = []
    t = time.perf_counter()
    for k in range(TRAIN_STEPS):
        state, loss = step(state, 1000 + k)
        losses.append(float(loss))
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t
    k2_launches = mega_kernel.trace_regenerative_mega.record_launches
    replay_launches = mega_diff.replay_backward.launches
    err1 = float((state.params["tex_ca"].detach() - true_ca).abs().mean())
    phase("main_path_training", f"{TRAIN_STEPS} adam steps (lr 5e-2) in "
          f"{train_s:.2f} s: loss {losses[0]:.6g} -> {losses[-1]:.6g}; mean "
          f"|tex_ca - true| {err0:.4f} -> {err1:.4f}; K2 launches "
          f"{k2_launches}, replay launches {replay_launches}")
    if not (losses[-1] < losses[0] and err1 < err0 and np.isfinite(losses).all()):
        raise AssertionError(f"training did not improve: {losses}")
    if k2_launches < 1 or replay_launches < 1:
        raise AssertionError("the training path did not launch K2 and the replay")

    # 9. Timing at the bench size.
    st_c, got_c, bcam, _ = rec["cornell"]
    pix, samp = lanes(BW, BH, dev)
    bkw = dict(width=BW, height=BH, sample_stride=1, sample_end=BSPP,
               spp_cap=BSPP, max_depth=BDEPTH, t_min=1e-3,
               record_iters=BSPP * BDEPTH)
    run, _ = mega_kernel.prepare_launch(cornell, bcam, pix, samp, 0, **bkw)
    k2_ms, _ = cuda_ms(bare(run), dev, 5)
    k2_plain_ms, _ = cuda_ms(lambda: mega_kernel.trace_regenerative_mega_reference(
        cornell, bcam, pix, samp, 0, **bkw), dev, 3)
    run, _ = mega_diff.prepare_replay(*replay_args)
    replay_ms, _ = cuda_ms(bare(run), dev, 5)
    replay_plain_ms, _ = cuda_ms(
        lambda: mega_diff.replay_backward_reference(*replay_args), dev, 3)
    phase("timing_kernels", f"cornell {BW}x{BH} spp{BSPP} depth{BDEPTH}: K2 "
          f"alone {k2_ms:.3f} ms vs plain {k2_plain_ms:.1f} ms ({k2_regs} "
          f"registers); replay alone "
          f"{replay_ms:.3f} ms vs plain {replay_plain_ms:.1f} ms")

    params, _ = diff.split_params(cornell)
    bench_target = torch.zeros((BW * BH, 3), device=dev)
    skw = dict(width=BW, height=BH, spp=BSPP, samples_per_pass=1,
               max_depth=BDEPTH, t_min=1e-3)

    def fwd_bwd():
        return diff.render_value_and_grad(params, cornell, bcam, bench_target,
                                          0, **skw)

    step_ms, step_runs = cuda_ms(fwd_bwd, dev, 5)
    with plain_versions():
        step_plain_ms, _ = cuda_ms(fwd_bwd, dev, 3)
    with fused(False):
        step_lock_ms, _ = cuda_ms(fwd_bwd, dev, 3)
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_bwd()
        lock_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_bwd()
    fused_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    seg_b = st_c["segments"]
    phase("timing_step", f"fwd+bwd step {BW}x{BH} spp{BSPP} depth{BDEPTH} "
          f"(render_value_and_grad, CUDA events, median): kernels "
          f"{step_ms:.3f} ms (runs {step_runs}), {seg_b / step_ms / 1e3:.1f} "
          f"Mrays/s, peak {fused_peak:.2f} GiB; plain versions on the card "
          f"{step_plain_ms:.1f} ms; lockstep autograd {step_lock_ms:.1f} ms, "
          f"peak {lock_peak:.2f} GiB ({seg_b} K2 segments)")

    here = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-m", "another_raytracer_tpu_torch.bench"],
                         cwd=here, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bench failed:\n{res.stdout}\n{res.stderr}")
    bench_line = res.stdout.strip().splitlines()[-1]
    bench = json.loads(bench_line)
    if not (bench["value"] > 0 and bench["segments"] > 0):
        raise AssertionError(f"bench line is wrong: {bench_line}")
    phase("bench", bench_line)

    # 10. The wavefront of BVH and texture scenes.  K5 against its plain
    # version on ~400k rays, every variant of each tree kind.
    from another_raytracer_tpu_torch.models.scene import SceneBuilder
    from another_raytracer_tpu_torch.ops import bvh as bvh_ops
    from another_raytracer_tpu_torch.ops import shade
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel, perlin_kernel
    from another_raytracer_tpu_torch.ops.vec3 import V3

    scene1, cam1 = library.random_scene(device=dev)
    cases = k5_cases(dev, scene1, cam1)
    k5_stats = []
    for case in cases:
        for fold, full, pre in K5_VARIANTS[case[7]]:
            st = compare_k5(case, fold, full, pre, dev)
            k5_stats.append(st)
            phase("compare_k5", f"{case[0]}: {json.dumps(st)}")
    k5_verdict = ("bit-equal on every lane and every output"
                  if all(st["bit_equal"] for st in k5_stats)
                  else "within the test_mega bar")
    phase("compare_k5", f"{len(k5_stats)} comparisons: {k5_verdict}")

    # 11. K4 against its plain version on 1M points of three table sets, at
    # small and large magnitude and both signs (the final scene evaluates
    # noise at scale 0.1 at |p| ~ 500).
    b = SceneBuilder(seed=3)
    for scale in (4.0, 0.1, 1.0):
        b.sphere((0, 0, 0), 1.0, b.lambertian(texture=b.noise_texture(scale)))
    noise_scene = b.build(device=dev)
    g = np.random.default_rng(1)
    npts = 1 << 20
    p = np.concatenate([g.uniform(-8, 8, (3, npts // 4)),
                        g.uniform(-50, 50, (3, npts // 4)),
                        g.uniform(-100, 0, (3, npts // 4)),
                        np.floor(g.uniform(-30, 30, (3, npts // 4)))], axis=1)
    pv = V3(*(torch.from_numpy(c.astype(np.float32)).to(dev) for c in p))
    ids = torch.from_numpy(g.integers(0, 3, npts)).to(dev)
    got = perlin_kernel.perlin_noise(noise_scene, ids, pv)
    want = shade.perlin_noise(noise_scene, ids, pv)
    torch.cuda.synchronize(dev)
    k4_err = float((got - want).abs().max())
    k4_equal = torch.equal(got, want)
    phase("compare_k4", f"{npts} points, 3 table sets: "
          f"{'bit-equal' if k4_equal else 'max abs err ' + repr(k4_err)}")
    if not (k4_equal or k4_err <= 1e-6) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K4 disagrees with its plain version: {k4_err}")

    # 12. The wavefront through the kernels against the same through the
    # plain versions, on the card.
    wave = [("scene 1 (random, sphere tree)", scene1, cam1),
            ("scene 3 (two Perlin spheres)", *library.two_perlin_spheres(device=dev)),
            ("scene 5 (simple light)", *library.simple_light(device=dev)),
            ("triangle sheet (BVH, barycentric + image textures)", *sheet_scene(dev))]
    wkw = dict(width=CW, height=CH, sample_start=0, n_samples=CSPP,
               spp_cap=CSPP, samples_per_pass=1, max_depth=DEPTH, t_min=1e-3)
    for name, sc, cp in wave:
        cam = camera_lib.make_camera(aspect_ratio=CW / CH, device=dev, **cp)
        pix = torch.arange(CW * CH, device=dev)
        reset_counts()
        with mega_forward(False):
            got, got_segs = render_lib.radiance_batch(sc, cam, pix, 7, **wkw)
            launched = counts()
            with plain_wavefront():
                ref, ref_segs = render_lib.radiance_batch(sc, cam, pix, 7,
                                                          **wkw)
        torch.cuda.synchronize(dev)
        st = forward_bar(got, ref, got_segs, ref_segs, name)
        st.update(K5_launches=launched["K5"], K4_launches=launched["K4"])
        if (sc.has_accel and launched["K5"] < 1) or (
                scene_lib.TEX_NOISE in sc.tex_kinds and launched["K4"] < 1):
            raise AssertionError(f"{name}: the wavefront skipped a kernel {st}")
        phase("compare_wavefront", f"{name} {CW}x{CH} spp{CSPP} depth{DEPTH}: "
              f"{json.dumps(st)}")

    # 13. The wavefront's BVH path: scene 1 through the CLI at the README
    # size with MEGA_FORWARD = False (its auto route is K3, section 16): the
    # forward gate's measurement of the wavefront + K5.
    with tempfile.TemporaryDirectory() as tmp, mega_forward(False):
        rc, out, img, launched = run_cli(1, W, H, SPP, DEPTH, tmp)
    bvh_wall_ms, bvh_mrays, bvh_segs = cli_stats(out)
    k5_launches = launched["K5"]
    if rc != 0 or k5_launches < 1 or launched["K1"] or bvh_segs <= 0:
        raise AssertionError(f"main path (scene 1): rc={rc} {launched}\n{out}")
    if img.shape != (H, W, 3) or img.mean() < 10.0:
        raise AssertionError(f"scene 1 image is wrong: {img.shape} {img.mean()}")
    phase("main_path_bvh", f"scene 1 {W}x{H} spp{SPP} depth{DEPTH} (CLI, "
          f"wavefront + K5): "
          f"{bvh_wall_ms} ms wall, {bvh_segs} segments, {bvh_mrays} Mrays/s; "
          f"launches {json.dumps(launched)}; PNG mean {img.mean():.2f}")

    # Where scene 1's render time goes, from a profiler trace at spp 1 (each
    # wavefront loop iteration launches K5 once).
    with mega_forward(False):
        wall_ms, busy_ms, n_kern, launched, top = profile_render(scene1, cam1,
                                                                 1, dev)
    iters = max(launched["K5"], 1)
    phase("profile_bvh", f"scene 1 {W}x{H} spp1 depth{DEPTH}: {wall_ms:.1f} ms "
          f"wall, {iters} loop iterations ({wall_ms / iters:.2f} ms each); "
          f"traced: device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% "
          f"of the bare wall), {n_kern} device ops "
          f"({n_kern / iters:.0f} per iteration); top by device time: "
          + "; ".join(f"{nm} {ms:.1f} ms / {c}" for nm, ms, c in top[:8]))

    # 14. The texture main path: scenes 3, 4 and 5 through the CLI.
    k4_launches = 0
    for sid in (3, 4, 5):
        with tempfile.TemporaryDirectory() as tmp:
            rc, out, img, launched = run_cli(sid, W, H, TEX_SPP, DEPTH, tmp)
        wall_ms, mrays, segs = cli_stats(out)
        if rc != 0 or segs <= 0 or (sid in (3, 5) and launched["K4"] < 1):
            raise AssertionError(f"main path (scene {sid}): rc={rc} {launched}")
        if img.shape != (H, W, 3) or img.mean() < 2.0:
            raise AssertionError(f"scene {sid} image is wrong: {img.mean()}")
        k4_launches += launched["K4"]
        phase("main_path_textures", f"scene {sid} {W}x{H} spp{TEX_SPP} "
              f"depth{DEPTH} (CLI): {wall_ms} ms wall, {segs} segments, "
              f"{mrays} Mrays/s; launches {json.dumps(launched)}; PNG mean "
              f"{img.mean():.2f}")

    # 15. K5 and K4 alone (CUDA events after a synchronise) at the main
    # path's widths, beside their plain versions and their bounds.  K5: the
    # first call of the scene-1 render, its camera rays (388,800 lanes)
    # against the sphere tree with the sphere fold (the render's first stage
    # is above FOLD_SPH_MIN_B).
    from another_raytracer_tpu_torch.ops import intersect

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    pix, samp = lanes(W, H, dev)
    o, d, tm = camera_lib.generate_rays(cam, pix, samp, W, H, 0,
                                        needs_time=scene1.has_motion)
    n = W * H
    init_t = torch.full((n,), 3e37, device=dev)
    init_i = torch.zeros(n, dtype=torch.int32, device=dev)
    nodes, rows = scene1.sph_bvh_nodes, scene1.sph_bvh_rows
    kkw = dict(leaf_size=scene1.bvh_leaf_size, t_min=1e-3, prim="sphere",
               time=tm)
    if n < intersect.FOLD_SPH_MIN_B:
        raise AssertionError("the timed K5 call is below the fold's gate")
    k5_times = {}
    for label, fold in (("fold", True), ("no fold", False)):
        run, _ = bvh_kernel.prepare_launch(nodes, rows, o, d, init_t, init_i,
                                           fold_record=fold, **kkw)
        k5_times[label] = cuda_ms(bare(run), dev, 10)[0]
    lib_of = bvh_kernel._lib
    bvh_kernel._lib = lambda: lib_of("bvh_kernel_fma")
    try:
        run, _ = bvh_kernel.prepare_launch(nodes, rows, o, d, init_t, init_i,
                                           fold_record=True, **kkw)
    finally:
        bvh_kernel._lib = lib_of
    k5_times["fold, FMA build"] = cuda_ms(bare(run), dev, 10)[0]
    k5_ms = k5_times["fold"]
    k5_plain_ms, _ = cuda_ms(lambda: bvh_ops.traverse_packed(
        nodes, rows, o, d, tm, 1e-3, init_t, init_i,
        leaf_size=scene1.bvh_leaf_size, prim="sphere", fold_record=True), dev, 1)
    work = bvh_ops.traverse_packed(nodes, rows, o, d, tm, 1e-3, init_t, init_i,
                                   leaf_size=scene1.bvh_leaf_size,
                                   prim="sphere", fold_record=True, counts=True)
    slabs, tests = int(work[-2].sum()), int(work[-1].sum())
    k5_ops = (slabs * bvh_ops.OPS_PER_SLAB
              + tests * bvh_ops.OPS_PER_TEST["sphere", False]
              + int(work[2].sum()) * bvh_ops.OPS_PER_FOLD["sphere", False])
    k5_bytes = (nodes.numel() + rows.numel()) * 4 + n * (9 * 4 + 9 + 5 * 4)
    k5_bound_ms, k5_bound_by = bound(k5_ops, k5_bytes)
    phase("timing_k4_k5", f"K5, scene 1's first call ({n} camera rays, sphere "
          f"tree of {scene1.n_spheres} spheres, leaf {scene1.bvh_leaf_size}): "
          f"{json.dumps({k: round(v, 4) for k, v in k5_times.items()})} ms; "
          f"plain {k5_plain_ms:.1f} ms; {slabs} slab tests and {tests} sphere "
          f"tests ({slabs / n:.1f} / {tests / n:.1f} per ray): bound "
          f"{k5_bound_ms:.4f} ms by {k5_bound_by}; {k5_launches} launches per "
          f"scene-1 render")
    tri = cases[1]
    args, kw = k5_args(tri, dev)
    tri_times = {}
    for fold, full, pre in K5_VARIANTS["planar"]:
        run, _ = bvh_kernel.prepare_launch(*args, t_min=1e-3, fold_record=fold,
                                           fold_full=full, precomp=pre, **kw)
        tri_times[f"fold={int(fold)} full={int(full)} precomp={int(pre)}"] = (
            round(cuda_ms(bare(run), dev, 5)[0], 4))
    phase("timing_k4_k5", f"K5 on {tri[0]} ({args[2].x.shape[0]} rays), "
          f"planar variants: {json.dumps(tri_times)} ms")

    scene3, _ = library.two_perlin_spheres(device=dev)
    g = np.random.default_rng(2)
    pv = V3(*(torch.from_numpy(g.uniform(-20, 20, n).astype(np.float32)).to(dev)
              for _ in range(3)))
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    run, _ = perlin_kernel.prepare_launch(scene3, ids, pv)
    k4_ms, _ = cuda_ms(bare(run), dev, 10)
    k4_plain_ms, _ = cuda_ms(lambda: shade.perlin_noise(scene3, ids, pv), dev, 3)
    k4_bound_ms, k4_bound_by = bound(
        n * OPS_PERLIN, n * (3 * 4 + 4 + 4) + scene3.per_perm.numel() * 8)
    phase("timing_k4_k5", f"K4, {n} points of scene 3's table set: {k4_ms:.4f} "
          f"ms; plain {k4_plain_ms:.3f} ms; bound {k4_bound_ms:.4f} ms by "
          f"{k4_bound_by}; {k4_launches} launches in scenes 3, 4 and 5's renders")

    # 16. The megakernel's accel mode (K3).  Its forward instance against
    # its plain version on scene 1 and the 81-sphere tree.
    k3_cmp = {}
    for name, (sc, cp) in [("scene 1 (random)", (scene1, cam1)),
                           ("81-sphere tree", bvh_sphere_scene(dev))]:
        reset_counts()
        st = compare(sc, cp, CW, CH, CSPP, DEPTH, dev, what="K3")
        if counts()["K3"] != 1:
            raise AssertionError(f"{name}: the comparison skipped K3 {counts()}")
        k3_cmp[name] = st
        phase("compare_k3", f"{name} {CW}x{CH} spp{CSPP} depth{DEPTH}: "
              f"{json.dumps(st)}")

    # Its record instance and the replay at scene 1's 485 textures (the
    # block-wide table) at the bench size.
    st_k3r, got_k3r, bcam1 = compare_record(scene1, cam1, dev, what="K3 record")
    phase("compare_k3_record", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}: "
          f"{json.dumps(st_k3r)}")
    rp485, (rp485_args, _) = compare_replay(scene1, got_k3r, dev)
    if not mega_diff.replay_instance(rp485["textures"])[0]:
        raise AssertionError("scene 1's replay did not take the block-wide table")
    phase("compare_replay", f"scene 1, {rp485['textures']} textures (block-wide "
          f"table, atomics): {json.dumps(rp485)}")

    # The accel main path: the scene-1 README render through the CLI, in
    # single and in adaptive mode.
    accel_cli, pngs = {}, {}
    for mode in ("single", "adaptive"):
        with tempfile.TemporaryDirectory() as tmp:
            rc, out, img, launched = run_cli(1, W, H, SPP, DEPTH, tmp, mode)
        wall_ms, mrays, segs = cli_stats(out)
        if (rc != 0 or launched["K3"] < 1 or launched["K5"] or launched["K1"]
                or segs <= 0):
            raise AssertionError(f"main path (scene 1, {mode}): rc={rc} "
                                 f"{launched}\n{out}")
        if img.shape != (H, W, 3) or img.mean() < 10.0:
            raise AssertionError(f"scene 1 {mode} image is wrong: {img.mean()}")
        accel_cli[mode], pngs[mode] = (wall_ms, mrays, segs, launched), img
        phase("main_path_accel", f"scene 1 {W}x{H} spp{SPP} depth{DEPTH} "
              f"(CLI, mode {mode}): {wall_ms} ms wall, {segs} segments, {mrays} "
              f"Mrays/s; launches {json.dumps(launched)}; PNG mean "
              f"{img.mean():.2f}")
    # The adaptive render traces every big square's corners with the same
    # kernel and keys as the single render: the same colours there.
    corners = np.zeros((H, W), bool)
    for y0 in (0, 11):
        for x0 in (0, 11):
            corners[y0::12, x0::12] = True
    if not np.array_equal(pngs["adaptive"][corners], pngs["single"][corners]):
        raise AssertionError("adaptive corners differ from the single render")
    k3_launches = accel_cli["single"][3]["K3"]
    phase("main_path_accel", f"adaptive vs single: corners equal, median |diff| "
          f"{np.median(np.abs(pngs['adaptive'].astype(int) - pngs['single'])):.1f}"
          f", {accel_cli['adaptive'][2] / accel_cli['single'][2]:.3f} of the "
          f"segments")

    # The fused training path on scene 1 at the bench size: fused (K3's
    # record instance and the replay) against lockstep gradients.
    bkw1 = dict(width=BW, height=BH, spp=BSPP, samples_per_pass=1,
                max_depth=BDEPTH, t_min=1e-3)
    params1, _ = diff.split_params(scene1)
    with torch.no_grad():
        acc, _ = render_lib.render_radiance(scene1, bcam1, 99,
                                            differentiable=True, **bkw1)
    target1 = torch.stack(tuple(acc), dim=1) / BSPP
    reset_counts()
    loss_all, errs_all, loss_rel, errs, n_flipped = fused_vs_lockstep(
        scene1, bcam1, target1, params1, bkw1, dev)
    train_launched = counts()
    phase("main_path_accel_training", f"scene 1 {BW}x{BH} spp{BSPP} "
          f"depth{BDEPTH}, fused vs lockstep: all pixels loss rel "
          f"{loss_all:.2e}, gradient rel L2 {json.dumps(errs_all)}; without the "
          f"{n_flipped} of {BW * BH} pixels whose paths differ: loss rel "
          f"{loss_rel:.2e}, gradient rel L2 {json.dumps(errs)}; launches "
          f"{json.dumps(train_launched)}")
    if loss_rel > 1e-3 or max(errs.values()) > 1e-2:
        raise AssertionError("fused and lockstep gradients disagree on scene 1")
    if train_launched["K3_record"] < 1 or train_launched["replay"] < 1:
        raise AssertionError("scene 1's training path skipped K3 or the replay")

    # K3 alone at the README size (Morton-ordered lanes, as the render runs
    # it), through its wrapper, and its plain version once (which also
    # counts the walk's slab and sphere tests: the bound's work).
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    order, _ = render_lib.morton_order(W, H)
    pix_m = torch.from_numpy(order.astype(np.int64)).to(dev)
    samp_m = torch.zeros_like(pix_m)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    run, (k3_out, k3_seg) = mega_kernel.prepare_launch(scene1, cam, pix_m,
                                                       samp_m, 0, **kw)
    k3_ms, k3_runs = cuda_ms(bare(run), dev, 5)
    k3_wrap_ms, _ = cuda_ms(lambda: mega_kernel.trace_regenerative_mega(
        scene1, cam, pix_m, samp_m, 0, **kw), dev, 3)
    segs_k3 = int(k3_seg.sum())
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    ref_k3 = mega_kernel.trace_regenerative_mega_reference(
        scene1, cam, pix_m, samp_m, 0, work=True, **kw)
    torch.cuda.synchronize(dev)
    k3_plain_ms = (time.perf_counter() - t) * 1e3
    # At 100 samples a lane nearly always holds a path that FMA contraction
    # flipped, so the per-lane bar (made for a few samples, compare_k3)
    # does not apply: hold the segments and the image's mean radiance.
    got_mean = float(torch.stack(k3_out).mean())
    plain_mean = float(torch.stack(tuple(ref_k3[0])).mean())
    st_full = dict(segments_plain=int(ref_k3[1]),
                   mean_radiance=got_mean, mean_radiance_plain=plain_mean)
    if (abs(segs_k3 - int(ref_k3[1])) > 0.01 * int(ref_k3[1])
            or abs(got_mean - plain_mean) > 0.01 * plain_mean):
        raise AssertionError(f"K3 at the README size disagrees with its "
                             f"plain version: {st_full}")
    slabs3, tests3 = ref_k3[-1]
    nodes_bytes = scene1.sph_bvh_nodes.numel() * 4
    rows_bytes = scene1.sph_bvh_rows.shape[0] * mega_kernel.ROW_W * 4
    k3_bound_ms, k3_bound_by = bound(
        slabs3 * bvh_ops.OPS_PER_SLAB
        + tests3 * bvh_ops.OPS_PER_TEST["sphere", False]
        + segs_k3 * (OPS_SEGMENT + OPS_K3_NORMAL),
        W * H * 24 + rows_bytes + nodes_bytes)
    phase("timing_k3", f"scene 1 {W}x{H} spp{SPP} depth{DEPTH}: K3 alone "
          f"{k3_ms:.3f} ms (runs {k3_runs}), {k3_regs} registers, no spills; "
          f"through its wrapper {k3_wrap_ms:.3f} ms; {segs_k3} segments, "
          f"{segs_k3 / k3_ms / 1e3:.1f} Mrays/s; plain {k3_plain_ms:.1f} ms "
          f"({json.dumps(st_full)}); {slabs3} slab and {tests3} sphere tests "
          f"({slabs3 / segs_k3:.1f} / {tests3 / segs_k3:.1f} per segment): "
          f"bound {k3_bound_ms:.3f} ms by {k3_bound_by}")

    # The forward gate: the scene-1 README render through K3 and through the
    # wavefront + K5 (section 13), both through the CLI.
    k3_wall = accel_cli["single"][0]
    phase("gate", f"forward, scene 1 {W}x{H} spp{SPP} depth{DEPTH} through the "
          f"CLI: K3 {k3_wall} ms wall (kernel {k3_ms:.3f} ms, "
          f"{100 * k3_ms / max(k3_wall, 1):.1f}% of the wall), wavefront + K5 "
          f"{bvh_wall_ms} ms wall ({bvh_wall_ms / max(k3_wall, 1):.1f}x); auto "
          f"takes K3: {mega_kernel.enabled(scene1, cam)}")
    if not (k3_wall < bvh_wall_ms and mega_kernel.enabled(scene1, cam)):
        raise AssertionError("the forward gate's default disagrees with its "
                             "measurement")

    # The fused gate: a fwd+bwd step on scene 1 at the bench size, fused
    # against lockstep.
    zero_target = torch.zeros((BW * BH, 3), device=dev)

    def step1():
        return diff.render_value_and_grad(params1, scene1, bcam1,
                                              zero_target, 0, **bkw1)

    fused_ms, fused_runs = cuda_ms(step1, dev, 5)
    with fused(False):
        lock_ms, lock_runs = cuda_ms(step1, dev, 2)
    fused_auto = mega_diff.enabled(scene1, bcam1, BSPP, 1, BDEPTH,
                                   trainable=tuple(params1))
    phase("gate", f"fused, scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH} fwd+bwd "
          f"step (render_value_and_grad, CUDA events, median): fused "
          f"{fused_ms:.3f} ms (runs {fused_runs}), lockstep {lock_ms:.1f} ms "
          f"(runs {lock_runs}) ({lock_ms / fused_ms:.1f}x); auto takes the "
          f"fused path: {fused_auto}")
    if not (fused_ms < lock_ms and fused_auto):
        raise AssertionError("the fused gate's default disagrees with its "
                             "measurement")

    # K3's record instance and the large-T replay alone at the bench size.
    pixb, sampb = lanes(BW, BH, dev)
    rkw = dict(width=BW, height=BH, sample_stride=1, sample_end=BSPP,
               spp_cap=BSPP, max_depth=BDEPTH, t_min=1e-3,
               record_iters=BSPP * BDEPTH)
    run, _ = mega_kernel.prepare_launch(scene1, bcam1, pixb, sampb, 0, **rkw)
    k3r_ms, _ = cuda_ms(bare(run), dev, 5)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    ref_k3r = mega_kernel.trace_regenerative_mega_reference(
        scene1, bcam1, pixb, sampb, 0, work=True, **rkw)
    torch.cuda.synchronize(dev)
    k3r_plain_ms = (time.perf_counter() - t) * 1e3
    slabs3r, tests3r = ref_k3r[-1]
    resid = BSPP * BDEPTH * BW * BH * 16
    k3r_bound_ms, k3r_bound_by = bound(
        slabs3r * bvh_ops.OPS_PER_SLAB
        + tests3r * bvh_ops.OPS_PER_TEST["sphere", False]
        + st_k3r["segments"] * (OPS_SEGMENT + OPS_K3_NORMAL),
        BW * BH * 24 + rows_bytes + nodes_bytes + resid)
    run, _ = mega_diff.prepare_replay(*rp485_args)
    rp485_ms, _ = cuda_ms(bare(run), dev, 5)
    rp485_plain_ms, _ = cuda_ms(
        lambda: mega_diff.replay_backward_reference(*rp485_args), dev, 3)
    rp485_bound_ms, rp485_bound_by = bound(
        BSPP * BDEPTH * BW * BH * OPS_REPLAY_ROW, resid + BW * BH * 12)
    phase("timing_k3", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}: K3 record "
          f"alone {k3r_ms:.3f} ms vs plain {k3r_plain_ms:.1f} ms ({k3r_regs} "
          f"registers), bound {k3r_bound_ms:.4f} ms by {k3r_bound_by}; replay "
          f"at T = {rp485['textures']} alone {rp485_ms:.3f} ms vs plain "
          f"{rp485_plain_ms:.1f} ms, bound {rp485_bound_ms:.4f} ms by "
          f"{rp485_bound_by}")

    # Bounds of the earlier kernels from this run's work: segments x the
    # per-segment operations; the bytes a lane reads and writes, the rows,
    # and K2's / the replay's residual rows.
    row_bytes = (cornell.n_spheres + cornell.n_rects) * mega_kernel.ROW_W * 4
    seg_ops = (cornell.n_spheres * OPS_SPHERE_ROW + cornell.n_rects * OPS_RECT_ROW
               + OPS_SEGMENT)
    k1_bound_ms, k1_bound_by = bound(segs_k * seg_ops, W * H * 24 + row_bytes)
    resid = BSPP * BDEPTH * BW * BH * 16
    k2_bound_ms, k2_bound_by = bound(st_c["segments"] * seg_ops,
                                     BW * BH * 24 + row_bytes + resid)
    rp_bound_ms, rp_bound_by = bound(BSPP * BDEPTH * BW * BH * OPS_REPLAY_ROW,
                                     resid + BW * BH * 12)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"kernels": [
        {"name": "mega_kernel forward instance (K1, forward sweep megakernel)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:224",
         "launches": k1_launches,
         "max_abs_err": results["cornell"]["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
         "wrapper_ms": k1_wrap_ms, "registers": k1_regs,
         "segments": segs_k, "mrays_per_s": segs_k / k1_ms / 1e3},
        {"name": "mega_kernel record instance (K2, fused differentiable primal)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:691",
         "launches": k2_launches,
         "max_abs_err": st_c["max_abs_err"],
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
         "registers": k2_regs,
         "lanes_codes_equal": st_c["lanes_codes_equal"]},
        {"name": "mega_kernel accel forward instance (K3, megakernel with "
                 "the sphere-BVH walk)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:882",
         "launches": k3_launches,
         "max_abs_err": k3_cmp["scene 1 (random)"]["max_abs_err"],
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound_ms, "bound_by": k3_bound_by, "library_ms": None,
         "wrapper_ms": k3_wrap_ms, "registers": k3_regs,
         "segments": segs_k3, "mrays_per_s": segs_k3 / k3_ms / 1e3},
        {"name": "mega_kernel accel record instance (K3, fused "
                 "differentiable primal on a sphere tree)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:882",
         "launches": train_launched["K3_record"],
         "max_abs_err": st_k3r["max_abs_err"],
         "ms": k3r_ms, "plain_ms": k3r_plain_ms,
         "bound_ms": k3r_bound_ms, "bound_by": k3r_bound_by,
         "library_ms": None, "registers": k3r_regs,
         "lanes_codes_equal": st_k3r["lanes_codes_equal"],
         "bit_equal": st_k3r["bit_equal"]},
        {"name": "mega_replay (replay backward of the fused path)",
         "route": "cuda", "source": SRC + "mega_replay.cu",
         "replaces": JAX_PALLAS + "mega_diff.py:266",
         "launches": replay_launches,
         "max_abs_err": replay_stats["max_abs_err"],
         "ms": replay_ms, "plain_ms": replay_plain_ms,
         "bound_ms": rp_bound_ms, "bound_by": rp_bound_by, "library_ms": None,
         "textures": replay_stats["textures"],
         "large_t": {"textures": rp485["textures"],
                     "instance": "block-wide table",
                     "launches": train_launched["replay"],
                     "max_abs_err": rp485["max_abs_err"],
                     "ms": rp485_ms, "plain_ms": rp485_plain_ms,
                     "bound_ms": rp485_bound_ms,
                     "bound_by": rp485_bound_by}},
        {"name": "bvh_kernel (K5, BVH closest hit)",
         "route": "cuda", "source": SRC + "bvh_kernel.cu",
         "replaces": JAX_PALLAS + "bvh_kernel.py:537",
         "launches": k5_launches,
         "max_abs_err": max(st["max_abs_err_t"] for st in k5_stats),
         "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound_ms, "bound_by": k5_bound_by, "library_ms": None,
         "variant_ms": k5_times, "planar_variant_ms": tri_times,
         "comparison": k5_verdict},
        {"name": "perlin_kernel (K4, Perlin noise)",
         "route": "cuda", "source": SRC + "perlin_kernel.cu",
         "replaces": JAX_PALLAS + "perlin_kernel.py:136",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound_ms, "bound_by": k4_bound_by, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke finished in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    sys.exit(rc)
