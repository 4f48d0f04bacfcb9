#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``another_raytracer_tpu_torch/csrc`` (one
nvcc per target, in parallel), then drives both main paths of the port and
holds every kernel against its plain PyTorch version:

* serving: threefry words bit for bit, the forward megakernel (K1) against
  its plain version on three scenes, the README render (Cornell 720x540,
  spp 100, depth 50) through the CLI, and K1's time;
* training: the record-mode megakernel (K2) and the replay backward against
  their plain versions at the bench size (Cornell 360x270, spp 16, depth 8),
  the fused gradients against the lockstep autograd path, 24 adam steps of
  the inverse-rendering demo's protocol, and the times of K2, the replay,
  one fwd+bwd step through the kernels, through the plain versions and
  through the lockstep path, and ``python -m another_raytracer_tpu_torch.bench``.

Every phase prints one line and any failure raises (non-zero exit).  The
last three lines are the card's name and power limit (nvidia-smi), a JSON
object describing each kernel, and ``{"ok": true, "device": {...}}``.

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

W, H, SPP, DEPTH = 720, 540, 100, 50  # README render (serving)
BW, BH, BSPP, BDEPTH = 360, 270, 16, 8  # bench.py (training)
TW, TH, TSPP, TDEPTH = 180, 135, 8, 6  # scripts/train_demo.py, chip size
TRAIN_STEPS = 24
K1_PR1_MS = 18.596  # K1 alone, README render (PERF.md, H100 80GB HBM3, 700 W)
SRC = "another_raytracer_tpu_torch/csrc/"
JAX_PALLAS = "another_raytracer_tpu/ops/pallas/"


def phase(name, line):
    print(f"[{name}] {line}", flush=True)


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


def compare(scene, cam_params, width, height, spp, depth, device, seed=3):
    """K1 vs its plain version on the same lanes; raises unless within bar."""
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
    return forward_bar(got, ref, got_segs, ref_segs, "K1")


def compare_record(scene, cam_params, device, seed=0):
    """K2 vs its plain version at the bench size: the forward bar, codes
    equal on >= 98% of lanes (event and end bit on every row; texture id and
    checker bit where the event is a scatter or a light hit), and tprev
    within 1e-5 on equal lanes.  Returns (stats, K2 outputs, cam)."""
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
    stats = forward_bar(got[0], ref[0], got[1], ref[1], "K2")
    c, rc = got[2], ref[2]
    ev_end = ((c & 7) == (rc & 7)).all(dim=0)
    live = ((rc & 3) == 1) | ((rc & 3) == 2)
    tid_odd = torch.where(live, (c >> 3) == (rc >> 3), True).all(dim=0)
    equal = ev_end & tid_odd
    frac = float(equal.float().mean())
    tp_err = max(float((a - b)[:, equal].abs().max()) for a, b in zip(got[3], ref[3]))
    stats.update(lanes_codes_equal=frac, tprev_max_err_equal_lanes=tp_err)
    if frac < 0.98 or tp_err > 1e-5:
        raise AssertionError(f"K2 residual rows disagree: {stats}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this check needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.models import library
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
    k1_regs, k1_spilled = kernel_usage(_build.build_log("mega_kernel"),
                                       "mega_forward_kernel")
    k2_regs, _ = kernel_usage(_build.build_log("mega_kernel_record"),
                              "mega_forward_kernel")
    if k1_spilled:
        raise AssertionError("K1's forward instance spills registers")

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
    trainable = tuple(sorted(params))
    # The two routes' float arithmetic flips a few paths.  Find the pixels
    # where a path differs: render both routes with every texture and the
    # background recoloured (colours steer no path, and with a lit background
    # every path that reaches a light or escapes shows in the radiance), and
    # drop the pixels whose radiance differs beyond float rounding.
    fp = cornell.replace(
        tex_ca=cornell.tex_ca * torch.as_tensor(
            np.random.default_rng(3).uniform(0.5, 1.5, tuple(cornell.tex_ca.shape)),
            dtype=torch.float32, device=dev),
        background=torch.tensor([0.3, 0.5, 0.7], device=dev))

    def images(scene):
        out = []
        for flag in (None, False):
            with fused(flag), torch.no_grad():
                a, _ = render_lib.render_radiance(scene, tcam, 555,
                                                  differentiable=True,
                                                  trainable=trainable, **tkw)
            out.append(torch.stack(tuple(a), dim=1) / TSPP)
        return out

    def differ(a, b):
        return ((a - b).abs() > 1e-4 * torch.maximum(a.abs(), b.abs())
                + 1e-6).any(dim=1)

    flipped = differ(*images(fp))
    img_f, img_l = images(cornell)
    if bool((differ(img_f, img_l) & ~flipped).any()):
        raise AssertionError("the demo image differs on a pixel whose paths agree")
    n_flipped = int(flipped.sum())
    if n_flipped > FLIP_BUDGET * flipped.numel():
        raise AssertionError(f"{n_flipped} of {flipped.numel()} pixels flipped")

    def value_and_grads(flag, tgt):
        with fused(flag):
            return diff.render_value_and_grad(params, cornell, tcam, tgt, 555,
                                              **tkw)

    def agreement(res_f, res_l):
        (loss_f, g_f), (loss_l, g_l) = res_f, res_l
        return (abs(float(loss_f) - float(loss_l)) / abs(float(loss_l)),
                {k: rel_l2(g_f[k], g_l[k]) for k in g_f})

    # The demo's loss as is, then with the flipped pixels dropped: there each
    # route's target is its own image, so the pixel adds no loss and no
    # gradient on either route.
    loss_all, errs_all = agreement(value_and_grads(None, target),
                                   value_and_grads(False, target))
    loss_rel, errs = agreement(
        value_and_grads(None, torch.where(flipped[:, None], img_f, target)),
        value_and_grads(False, torch.where(flipped[:, None], img_l, target)))
    phase("e2e_grads", f"cornell {TW}x{TH} spp{TSPP} depth{TDEPTH}, demo target, "
          f"fused vs lockstep: all pixels loss rel {loss_all:.2e}, gradient rel "
          f"L2 {json.dumps(errs_all)}; without the {n_flipped} of "
          f"{flipped.numel()} pixels whose paths differ: loss rel "
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
         "wrapper_ms": k1_wrap_ms, "registers": k1_regs,
         "segments": segs_k, "mrays_per_s": segs_k / k1_ms / 1e3},
        {"name": "mega_kernel record instance (K2, fused differentiable primal)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:691",
         "launches": k2_launches,
         "max_abs_err": st_c["max_abs_err"],
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "registers": k2_regs,
         "lanes_codes_equal": st_c["lanes_codes_equal"]},
        {"name": "mega_replay (replay backward of the fused path)",
         "route": "cuda", "source": SRC + "mega_replay.cu",
         "replaces": JAX_PALLAS + "mega_diff.py:266",
         "launches": replay_launches,
         "max_abs_err": replay_stats["max_abs_err"],
         "ms": replay_ms, "plain_ms": replay_plain_ms},
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
