#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``another_raytracer_tpu_torch/csrc`` (one
nvcc per target, in parallel), prints the registers and a static
instruction census (``cuobjdump -sass``) of every megakernel instance, then
drives the main paths of the port and holds every kernel against its plain
PyTorch version:

* serving: threefry words bit for bit (the megakernel's, and the draws
  kernel's, ``rng.uniform2`` on CUDA tensors), the forward megakernel
  (K1) against its plain version on three scenes, the README render
  (Cornell 720x540, spp 100, depth 50) through the CLI, and K1's time
  (lane fetch, against the per-block mapping's bit-equal outputs and
  time, and at each block size of ``BLOCKS``);
* training: the record-mode megakernel (K2, bit-equal) and the replay
  backward against their plain versions at the bench size (Cornell 360x270,
  spp 16, depth 8; the replay also on a 21-texture scene, bit for bit
  against itself, and reading K2's buffer where K2 wrote it, in the
  comparison and in a fused step), the replay's times (``replay_timings``:
  the launch, the backward as the step runs it, its live-row bound, its
  instance's shared memory and residency, and the launch on each instance
  and block, which must agree with ``replay_instance``'s pick), the
  sweep's counting instance (K1's and K2's row tests,
  active-lane shares and tails; K2's equal to the plain version's), the
  fused gradients against the lockstep autograd path, 24 adam steps of the
  inverse-rendering demo's protocol, and the times of K2, the replay, one
  fwd+bwd step through the kernels, through the plain versions and through
  the lockstep path, and ``python -m another_raytracer_tpu_torch.bench``;
* the wavefront of BVH and texture scenes: the BVH closest-hit kernel (K5)
  against its plain version on ~400k rays over the random scene's sphere
  tree, 10,240 triangles, 128 rects and the 128-triangle sheet (every fold
  variant, on both table routes where the tables fit shared memory), the
  Perlin kernel (K4) on 1M points, the wavefront through the kernels
  against the same through the plain versions on four scenes, the CLI on
  scene 1 (720x540, spp 100, depth 50), a profiler trace of scene 1 at spp
  1 (where the render's time goes, K5's share), the CLI on scenes 3, 4 and
  5 (spp 16; K4's mean points per launch; the segments of scenes 1, 3 and
  5 must equal ``WAVEFRONT_SEGMENTS``), and the two kernels' times
  (``graph_ms``) beside their bounds, with K5's counting build's tallies
  and its time at each block size of ``BLOCKS``, and the draws kernel's
  at 388,800 and 6,144 lanes beside its bound and its plain version's
  (``threefry_draws_timings``; every wavefront phase prints its launches,
  ``draws``, and ``plain_wavefront`` swaps in its plain version too);
* media and meshes (``media_phases``): scenes 7 and 8 and a 5,760-triangle
  capsule that ``write_capsule`` writes (scene 9 through ``--obj``), through
  the wavefront with K5 and K4 bit for bit against the same through their
  plain versions (96x72, spp 2, depth 8; K5's launches by tree and table
  route: scene 8's rect and sphere trees in shared memory, the mesh's
  planar tree in device memory); the CLI at 720x540, spp 16, depth 50
  (scenes 7 and 8 single, the mesh adaptive and single; segments must
  equal ``MEDIA_SEGMENTS``, and nothing may reach the megakernel or the
  replay); profiler traces of scene 8 and the mesh at spp 1 (the device's
  busy share, K5's and K4's shares); K5 on scene 8's first call (388,800
  camera rays on its rect and sphere trees) bit for bit against its plain
  version; K5 alone on the mesh's first call (388,800 camera rays on
  device-memory tables: ``graph_ms``, bound, tallies, blocks); and a
  lockstep gradient step on scene 7;
* the megakernel's accel mode (K3): its forward instance against its plain
  version on scene 1, an 81-sphere tree and a dense 6,000-sphere grid, its
  record instance bit-equal to its plain version at the bench size through
  both walks (scene 1's tables in shared memory, a 6,000-sphere tree's in
  device memory), the replay at scene 1's 485 textures against its plain
  version and bit for bit against itself, the scene-1
  README render through the CLI in single and adaptive mode, fused against
  lockstep gradients on scene 1 at the bench size, the two gate
  measurements (the scene-1 render through K3 and through the wavefront +
  K5; the fused and the lockstep step), K3 alone on the README render
  (its plain version at the README width and spp 4), the counting
  instance's walk totals (equal to the plain version's at the bench size;
  at the README size the work of K3's bound) and the active-lane shares of
  its walk, and the times of K3's two instances (at each block size of
  ``BLOCKS``) beside their bounds and the replay's at 485 textures.

* the entry points over the same kernels: the host library
  (``csrc/host``, built by the host C++ compiler beside the nvcc builds);
  the README render in the stripes and images modes through the CLI and
  over ``[cuda:0] x 4`` (4x1, 1x4, 2x2; stripes bit-equal to single mode,
  images to rtol 1e-5 with < 0.1% of pixels off, K1 once per shard), 1x8
  at spp 4 (four empty sample shards return zeros) and scene 1 in four
  stripes through K3 (``modes_phase``); the adaptive mode over 4x1 and 2x2
  of the card (one K1 launch per traced batch and shard);
  ``render_progressive`` with a checkpoint, stopped at spp 50
  and resumed (bit-equal to an uninterrupted run), timed with and without
  a PNG every pass; the CLI's ``--preview``, ``--checkpoint``,
  ``--profile-dir`` and ``--live``; JPEG (the committed samples bit-equal
  to the JAX package's stored native decodes, two with varying chroma, and
  the tinted ones within the PIL bar of PIL's stored decodes, scene 8 with a JPEG earthmap, a mesh with a JPEG
  ``map_Kd`` through the native parser); two processes on the card over
  gloo (``multihost_phase``); the sharded training step (4x1 fused, the
  ragged 7x1 fused, 1x2 lockstep, one adam update); and the two
  inverse-rendering demos of ``train_demo`` at their chip configuration
  and criteria (``train_demo_phase``: Cornell's 400 steps through its entry
  point, K2 and the replay; the atlas's 400 on the lockstep path);
* the JAX repo's last entry points (``bench_extra_phase``): every row of
  ``bench_extra.CONFIGS`` whose input exists (the capsule rows on
  ``write_capsule``'s mesh) at a reduced size through the kernels against
  the same through their plain versions, then once at its full size
  (``BX_SPP_CUTS``' rows with spp cut) through ``bench_extra.measure``,
  its record printed and its route held to ``BX_ROUTES``; and the scaling
  harness over ``[cuda:0] x 4``, its 1-device and 4-shard renders
  bit-equal.

The wavefront phases run with ``mega_kernel.MEGA_FORWARD = False``, which
sends scene 1 to the wavefront + K5 (its auto route is K3).  Every phase
prints one line with its seconds, and any failure raises (non-zero exit).
The last lines are the whole run's time, the host library's line, the
card's name and power limit (nvidia-smi), a JSON object describing each
kernel, and ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible or the
port package is not beside this script.  Imports no JAX.
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
TEX_SPP = 16  # scenes 3, 4 and 5 through the CLI, and 7, 8 and 9
MW, MH, MSPP, MDEPTH = 96, 72, 2, 8  # the media and mesh comparison
GW, GH, GSPP, GDEPTH = 180, 135, 4, 6  # the media gradient step (scene 7)
# Segments of the CLI renders through the wavefront at W x H, depth DEPTH
# (scene 1 at SPP with MEGA_FORWARD = False, scenes 3 and 5 at TEX_SPP):
# K5, K4 and the bounce kernel are bit-equal to their plain versions, so
# these move only with the wavefront's arithmetic (the sphere records' re-projection onto their
# spheres took scene 1 from 120,859,593, scene 3 from 16,145,816, scene 5
# from 10,753,141 and scene 8 from 33,376,402).
WAVEFRONT_SEGMENTS = {1: 115476704, 3: 15865454, 5: 10595931}
# The same for the media and mesh renders at spp TEX_SPP (the mesh is
# ``write_capsule``'s).
MEDIA_SEGMENTS = {"scene 7 single": 28428617, "scene 8 single": 26233288,
                  "scene 9 adaptive": 1120699, "scene 9 single": 10280559}
CW, CH, CSPP = 180, 135, 4  # the wavefront comparison
BW, BH, BSPP, BDEPTH = 360, 270, 16, 8  # bench.py (training)
TW, TH, TSPP, TDEPTH = 180, 135, 8, 6  # scripts/train_demo.py, chip size
TRAIN_STEPS = 24
DEMO_STEPS = 400  # the demos (train_demo_phase): the scripts' steps
MH_SPP, MH_TIMEOUT = 16, 300  # the multihost phase: spp, s per process
EW, EH, ESPP, JSPP = 360, 270, 8, 4  # the CLI-entry and JPEG phases
K3_PLAIN_SPP = 4  # K3's plain version at the README width
BLOCKS = (64, 128, 256, 384, 512)  # block sizes K1 and K3 are timed at
# Earlier times (PERF.md, H100 80GB HBM3, 700 W): K1 alone on the README
# render as first ported and on the 32-float rows with one lane per thread
# just before the 16-byte tables, and K2 alone at the bench size on those
# rows.
K1_FIRST_MS, K1_ROWS_MS, K2_ROWS_MS = 18.596, 17.395, 0.960
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
# K3 per segment: OPS_SEGMENT, the winner's point and normal re-projected
# onto its sphere (46, csrc/mega_kernel.cu's accel_hit and onto_sphere: the
# centre at the ray's time 8, 1/r 2, o + t d 6, the offset 3, the range
# test 6, |off|^2 5, the test of it 1, |r| / |off| 3, on 3, the normal 3,
# the point 6), and the walk's slab and sphere tests (ops/bvh.py's
# OPS_PER_SLAB, OPS_PER_TEST), counted by the plain version on the same
# inputs.
OPS_K3_WINNER = 46
# Operations per live residual row of the replay, and per point of K4
# (csrc/mega_replay.cu, csrc/perlin_kernel.cu).
OPS_REPLAY_ROW, OPS_PERLIN = 15, 96
# Integer operations per lane of the draws kernel (csrc/mega_kernel.cu's
# uniform2_draws_kernel): the key (4), the counters' injection (2), 13
# rounds of add, rotate (two shifts and an or) and xor (65), three key
# injections (9) and the two uniforms (6).
OPS_DRAWS = 86
# The replay's blocks timed per instance, and how much slower than the
# fastest instance and block replay_instance's pick may be (the spread of
# graph_ms between runs is a few percent).
REPLAY_BLOCKS = (32, 64, 128, 256)
REPLAY_PICK_SLACK = 1.10

_T0 = time.perf_counter()
_T_LAST = [_T0]


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


def many_spheres_scene(device, n=6000):
    """A tree too large for a block's shared memory, so K3 walks it from
    device memory: scene 1's spheres (library.add_random_spheres, drawn
    alike) plus spheres buried under its ground up to n in one tree (6,000:
    301,536 B of compact tables).  Rays never reach the buried spheres
    through the ground, so the image is scene 1's, but every downward ray
    walks their subtree, which comes first in the tree."""
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(background=library.SKY, seed=1234)
    kept = library.add_random_spheres(b)
    buried = b.lambertian(color=(0.5, 0.5, 0.5))
    for i in range(n - kept):
        b.sphere((0.5 * (i % 80) - 20, -1500.0 + 0.5 * (i // 6400),
                  0.5 * ((i // 80) % 80) - 20), 0.2, buried)
    cam = dict(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0,
               aperture=0.1, focus_dist=10.0, time0=0.0, time1=1.0)
    return b.build(device=device, bvh_leaf_size=32), cam


def dense_spheres_scene(device, n=6000):
    """A dense tree that K3 walks from device memory: scene 1's checker
    ground and n - 1 touching spheres of radius 0.25 in a 77-wide grid on
    it (eight shared materials: lambertian, metal, dielectric), under
    scene 1's camera.  Crowds of silhouettes and the radius-1000 ground are
    where FMA contraction in K3's forward build flips paths."""
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    rnd = np.random.default_rng(6)
    b = SceneBuilder(background=library.SKY, seed=1234)
    b.sphere((0, -1000, 0), 1000, b.lambertian(
        texture=b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    mats = [b.lambertian(color=tuple(rnd.uniform(0.1, 0.9, 3)))
            for _ in range(4)]
    mats += [b.metal(tuple(rnd.uniform(0.5, 1.0, 3)), f) for f in (0.0, 0.3)]
    mats += [b.dielectric(1.5)] * 2
    for i in range(n - 1):
        b.sphere((0.5 * (i % 77) - 19.0, 0.25, 0.5 * (i // 77) - 19.0), 0.25,
                 mats[i % len(mats)])
    cam = dict(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vfov=20.0,
               aperture=0.1, focus_dist=10.0, time0=0.0, time1=1.0)
    return b.build(device=device, bvh_leaf_size=32), cam


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
    positive random cotangent; gradients to rtol 1e-5, the same bits over
    repeated runs, and the launch reading the record buffer where K2 wrote
    it.  Returns (stats, the replay's arguments)."""
    import torch

    from another_raytracer_tpu_torch.ops.kernels import mega_diff
    from another_raytracer_tpu_torch.ops.vec3 import V3

    gen = torch.Generator(device=device).manual_seed(1)
    B = got[2].shape[1]
    ghat = V3(*(torch.rand(B, generator=gen, device=device) * 0.8 + 0.2
                for _ in range(3)))
    args = (got[2], got[3], ghat, scene.tex_ca, scene.tex_cb,
            scene.background, mega_diff._flags(scene), scene.replay_slots())
    kern = mega_diff.replay_backward(*args)
    plain = mega_diff.replay_backward_reference(*args[:7])
    torch.cuda.synchronize(device)
    err = 0.0
    for name, a, b in zip(("tex_ca", "tex_cb", "background"), kern, plain):
        bad = (a - b).abs() > 1e-5 * b.abs() + 1e-30
        if bool(bad.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"replay {name}: kernel {a.tolist()} vs "
                                 f"plain {b.tolist()}")
        err = max(err, float((a - b).abs().max()))
    deterministic = all(
        torch.equal(a, b) for _ in range(3)
        for a, b in zip(kern, mega_diff.replay_backward(*args)))
    if not deterministic:
        raise AssertionError(f"the replay changed bits between runs "
                             f"({scene.tex_ca.shape[0]} textures)")
    reads_record(mega_diff.replay_inputs(*args[:6], args[7]), got[3])
    return dict(textures=scene.tex_ca.shape[0],
                checker_rows=scene.replay_slots().checkers, max_abs_err=err,
                grad_tex_ca_max=float(plain[0].abs().max()),
                bit_deterministic=deterministic), args


def reads_record(inputs, tprev):
    """Raise unless a replay launch's inputs (``mega_diff.replay_inputs``)
    hold the record's tprev planes where the record kernel wrote them: views
    of its one [3, iters, B] buffer, not a copy."""
    plane = tprev.x.numel() * 4
    base = tprev.x.untyped_storage().data_ptr()
    for k, (t, ref) in enumerate(zip(inputs[1:4], tprev)):
        if (t.data_ptr() != ref.data_ptr() or t.data_ptr() != base + k * plane
                or ref.untyped_storage().data_ptr() != base):
            raise AssertionError(f"the replay does not read tprev plane {k} "
                                 "where the record kernel wrote it")


def replay_timings(args, dev, sms):
    """The replay at the bench size on one record's arguments (``args`` of
    ``compare_replay``): the launch alone by ``graph_ms`` and by events, the
    backward as the fused step runs it (``replay_backward``: wrapper, launch,
    the sum of the partial rows) by ``graph_ms``, a copy of the record as a
    wrapper that stacks the planes makes it, the bound from the live
    rows, the instance and its shared memory and residency, and the launch
    on each instance and block of ``REPLAY_BLOCKS``.  Raises if ``replay_instance``'s pick is more than
    ``REPLAY_PICK_SLACK`` slower than the fastest instance and block."""
    import torch

    from another_raytracer_tpu_torch.ops.kernels import mega_diff

    codes, tprev, ghat, ca = args[:4]
    T, C = ca.shape[0], args[7].checkers
    inst, block = mega_diff.replay_instance(T, C)

    def time(**kw):
        return graph_ms(lambda: mega_diff.prepare_replay(*args, **kw)[0],
                        dev)[0]

    def backward():
        mega_diff.replay_backward(*args)
        return 0

    def copy():
        torch.stack(tuple(tprev))
        torch.stack(tuple(ghat))
        return 0

    names = {mega_diff.LANE_COLUMNS: "columns", mega_diff.WARP_TABLES: "tables"}
    by_shape = {f"{names[i]} {b}": time(instance=i, block=b)
                for i in names for b in REPLAY_BLOCKS
                if mega_diff.replay_smem_bytes(T, C, b, i) <= 232448}
    ms = by_shape[f"{names[inst]} {block}"]
    best = min(by_shape, key=by_shape.get)
    if ms > REPLAY_PICK_SLACK * by_shape[best]:
        raise AssertionError(f"replay_instance picks {names[inst]} {block} "
                             f"({ms:.5f} ms) at T = {T}, but {best} takes "
                             f"{by_shape[best]:.5f} ms")
    work = mega_diff.replay_work(codes, T, C)
    bound_ms, bound_by = bound(work["live_rows"] * OPS_REPLAY_ROW,
                               work["bytes"])
    per_sm = mega_diff.replay_occupancy(T, C, block, inst)
    blocks = -(-codes.shape[1] // block)
    return dict(
        textures=T, checker_rows=C, ms=ms,
        event_ms=cuda_ms(bare(mega_diff.prepare_replay(*args)[0]), dev, 5)[0],
        backward_ms=graph_ms(lambda: backward, dev, 20)[0],
        copy_ms=graph_ms(lambda: copy, dev, 20)[0],
        plain_ms=cuda_ms(lambda: mega_diff.replay_backward_reference(
            *args[:7]), dev, 3)[0],
        bound_ms=bound_ms, bound_by=bound_by, rows=work["rows"],
        live_rows=work["live_rows"], bytes=work["bytes"],
        sector_bytes=work["sector_bytes"],
        sector_bound_ms=work["sector_bytes"] / PEAK_BYTES * 1e3,
        instance=names[inst], block=block,
        smem_bytes=mega_diff.replay_smem_bytes(T, C, block, inst),
        blocks=blocks, blocks_per_sm=per_sm,
        waves=blocks / max(per_sm * sms, 1),
        by_shape_ms=by_shape)


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
    mega_diff.replay_backward = (
        lambda *args: mega_diff.replay_backward_reference(*args[:7]))
    try:
        yield
    finally:
        mega_kernel.trace_regenerative_mega, mega_diff.replay_backward = saved


@contextlib.contextmanager
def spy(module, name, look):
    """Call ``look`` on what ``module.name`` returns, for as long as the
    block runs."""
    saved = getattr(module, name)

    def seen(*args, **kw):
        out = saved(*args, **kw)
        look(out)
        return out

    setattr(module, name, seen)
    try:
        yield
    finally:
        setattr(module, name, saved)


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


def graph_ms(prepare, dev, launches=100, runs=5):
    """The device time of one launch without the host's submission (for
    kernels of tens of microseconds, where ``cuda_ms`` also times the
    ctypes call): ``prepare()`` returns a bare launch (``prepare_launch``'s
    run, which binds the current stream, so it is called inside the
    capture); ``launches`` of them are captured in one CUDA graph, which is
    replayed between two events.  Returns (median ms per launch over
    ``runs`` replays, the runs)."""
    import torch

    bare(prepare())()  # outside the capture: the build and the module load
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        go = bare(prepare())
        for _ in range(launches):
            go()
    graph.replay()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize(dev)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize(dev)
        out.append(a.elapsed_time(b) / launches)
    return float(np.median(out)), [round(x, 5) for x in out]


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


# The megakernel's template instances <WALK> (mangled ILi<WALK>EE).
WALK_NAMES = {0: "sweep", 1: "shared", 2: "global"}


def _census_group(op):
    """The census's group of a SASS opcode, or None."""
    base = op.split(".")[0]
    if base == "LDS":
        return "LDS.128" if ".128" in op else "LDS"
    if base in ("BRA", "BRX", "JMP", "JMX"):
        return "branch"
    if base in ("LDC", "ULDC", "MUFU", "FFMA", "FMUL", "FADD", "DFMA", "DMUL",
                "DADD", "LDG", "CALL"):
        return base
    return None


def sass_census(lib_path):
    """Static instruction counts of each megakernel instance in a built
    library, from ``cuobjdump -sass``: {walk: {group: count}} with the
    groups of ``_census_group`` and ``all`` (every instruction)."""
    from another_raytracer_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    census, current = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            w = re.search(r"mega_forward_kernelILi(\d)EE", m.group(1))
            current = (census.setdefault(WALK_NAMES[int(w.group(1))], {})
                       if w else None)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", ln)
        if current is None or m is None:
            continue
        for group in ("all", _census_group(m.group(1))):
            if group:
                current[group] = current.get(group, 0) + 1
    if not census:
        raise AssertionError(f"no megakernel instance in {lib_path}")
    return census


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


def write_capsule(directory, segments=64, rings=45, texels=256):
    """Write a textured capsule as an .obj, its .mtl and a ``map_Kd`` PNG
    (a texels x texels checker) into ``directory``; returns the .obj's path.

    A closed surface around the origin along y: radius 0.5, a cylinder of
    length 1 and two hemispherical caps, ``segments`` quads around and
    ``rings`` quads from pole to pole, written as quad faces with
    texcoords (fan triangulation makes two triangles of each; at the poles
    one of them is degenerate and never hit).  Its stem is not one of the
    mesh scene's camera presets, so the scene takes the default camera."""
    import math

    from another_raytracer_tpu_torch.utils import imageio

    cap = (rings - rings // 3) // 2  # quad rings per cap; the rest: cylinder
    cyl = rings - 2 * cap
    prof = [(-0.5 + 0.5 * math.sin(a), 0.5 * math.cos(a)) for a in
            (-math.pi / 2 + math.pi / 2 * k / cap for k in range(cap + 1))]
    prof += [(-0.5 + k / cyl, 0.5) for k in range(1, cyl + 1)]
    prof += [(0.5 + 0.5 * math.sin(a), 0.5 * math.cos(a)) for a in
             (math.pi / 2 * k / cap for k in range(1, cap + 1))]
    lines = ["mtllib capsule.mtl", "usemtl checker"]
    for r, (y, rho) in enumerate(prof):
        for s in range(segments + 1):
            a = 2.0 * math.pi * s / segments
            lines.append(f"v {rho * math.cos(a):.7f} {y:.7f} "
                         f"{rho * math.sin(a):.7f}")
            lines.append(f"vt {s / segments:.7f} {r / rings:.7f}")
    row = segments + 1
    for r in range(rings):
        for s in range(segments):
            q = (r * row + s + 1, r * row + s + 2, (r + 1) * row + s + 2,
                 (r + 1) * row + s + 1)
            lines.append("f " + " ".join(f"{i}/{i}" for i in q))
    base = os.path.join(directory, f"capsule_{segments}x{rings}")
    with open(base + ".obj", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(directory, "capsule.mtl"), "w") as f:
        f.write("newmtl checker\nKa 0 0 0\nKd 0.8 0.8 0.8\n"
                "map_Kd checker.png\n")
    ij = np.add.outer(np.arange(texels), np.arange(texels)) // (texels // 8)
    img = np.where((ij % 2)[..., None] == 0, (230, 200, 40), (40, 60, 200))
    imageio.save_png(os.path.join(directory, "checker.png"),
                     img.astype(np.uint8))
    return base + ".obj"


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


def k5_sheet_case(dev):
    """The 128-triangle sheet's planar tree (``sheet_scene``: 35-column
    rows, tables in shared memory) with rays from a shell around it, in
    ``k5_cases``' form: the planar variants on K5's shared-memory route."""
    import torch

    sheet, _ = sheet_scene(dev)
    o, d = shell_rays(np.random.default_rng(1), W * H, 6.0, 2.5,
                      center=(0.0, 0.0, -3.0))
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return ("128-triangle sheet", sheet.bvh_packed_nodes, sheet.bvh_packed_tris,
            [t(c) for c in o], [t(c) for c in d],
            torch.zeros(W * H, device=dev), sheet.bvh_leaf_size, "planar")


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


def k5_main(prim, scene=None):
    """The variant (fold_record, fold_full, precomp) that K5's timings,
    tallies and bounds use on a ``prim`` tree: the wavefront's on
    ``scene`` at W x H lanes (``intersect.fold_tree``), or without a scene
    on one whose only tree it is (``k5_cases``' synthetic trees)."""
    import types

    from another_raytracer_tpu_torch.ops import intersect

    if scene is None:
        scene = types.SimpleNamespace(
            tri_in_bvh=prim == "planar", sph_in_bvh=prim == "sphere",
            n_bvh_nodes=int(prim == "planar"), sph_fold_safe=True)
    return intersect.k5_variant(prim, intersect.fold_tree(scene, W * H))


def k5_first_call(dev, scene1, cam1):
    """The case of the scene-1 render's first K5 call through the
    wavefront: its 388,800 camera rays against the sphere tree (in
    ``k5_cases``' form)."""
    from another_raytracer_tpu_torch.ops import camera as camera_lib

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    pix, samp = lanes(W, H, dev)
    o, d, tm = camera_lib.generate_rays(cam, pix, samp, W, H, 0,
                                        needs_time=scene1.has_motion)
    return ("scene 1's first call", scene1.sph_bvh_nodes, scene1.sph_bvh_rows,
            list(o), list(d), tm, scene1.bvh_leaf_size, "sphere")


def k5_work(case, fold, full, pre, dev):
    """K5's plain version on a case, with the work it does counted: (flat
    outputs, slab tests, leaf row tests, improved rays, the bound's ms and
    what bounds it).  Operations: ops/bvh.py's per-test counts; bytes: the
    nodes and rows, each ray's 9 inputs, and its t, code, flag and fold
    outputs."""
    from another_raytracer_tpu_torch.ops import bvh as bvh_ops

    args, kw = k5_args(case, dev)
    tm, prim = kw.pop("time"), kw["prim"]
    out = bvh_ops.traverse_packed(*args[:4], tm, 1e-3, *args[4:],
                                  fold_record=fold, fold_full=full,
                                  precomp=pre, counts=True, **kw)
    slabs, tests, hits = (int(out[-2].sum()), int(out[-1].sum()),
                          int(out[2].sum()))
    ops = (slabs * bvh_ops.OPS_PER_SLAB
           + tests * bvh_ops.OPS_PER_TEST[prim, pre]
           + (hits * bvh_ops.OPS_PER_FOLD[prim, pre] if fold else 0))
    n = args[2].x.shape[0]
    nbytes = ((args[0].numel() + args[1].numel()) * 4
              + n * (9 * 4 + 9 + 4 * bvh_ops.n_aux(prim, fold, full)))
    return (flat_out(out[:-2]), slabs, tests, hits) + bound(ops, nbytes)


def k5_tallies(case, fold, full, pre, dev, work=None, **launch):
    """K5's counting instance on one case (``bvh_kernel.tallies``), held to
    its plain version (``work``: ``k5_work``'s result, computed when None):
    the same t, codes and flags, and slab and leaf row totals equal to the
    plain version's counts.  Returns the tallies."""
    import torch

    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    want, slabs, tests = (work or k5_work(case, fold, full, pre, dev))[:3]
    args, kw = k5_args(case, dev)
    t, code, hit, tl = bvh_kernel.tallies(
        *args, t_min=1e-3, fold_record=fold, fold_full=full, precomp=pre,
        **kw, **launch)
    if ((slabs, tests) != (tl["slab_tests"], tl["leaf_tests"])
            or not all(torch.equal(a, b) for a, b in zip((t, code, hit),
                                                          want[:3]))):
        raise AssertionError(f"K5's counting instance on {case[0]} differs "
                             f"from its plain version: {tl} vs "
                             f"{(slabs, tests)}")
    return tl


def flat_out(out):
    """A K5 result as a flat list of tensors (V3 components spread)."""
    from another_raytracer_tpu_torch.ops.vec3 import V3

    return [x for v in out for x in (v if isinstance(v, V3) else (v,))]


def compare_k5(case, fold, full, pre, dev):
    """K5 vs its plain version on one case and variant, through the wrapper
    (the route ``table_route`` picks; it counts a launch) and, where that
    is shared memory, on the device-memory route too.  Bit-equal is the
    expectation (both round every operation alike); otherwise the test_mega
    bar on the lanes (<= 2% of lanes with another winner, median |t|
    difference < 1e-5).  Fold outputs are compared on hit lanes."""
    import torch

    from another_raytracer_tpu_torch.ops import bvh as bvh_ops
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    args, kw = k5_args(case, dev)
    kw.update(fold_record=fold, fold_full=full, precomp=pre)
    tables = bvh_kernel.pack_tables(args[0], args[1], case[7], pre)
    runs = {bvh_kernel.table_route(tables): flat_out(
        bvh_kernel.bvh_closest_hit(*args, tables=tables, **kw))}
    if "shared" in runs:
        run, (t, code, hit, aux) = bvh_kernel.prepare_launch(
            *args, t_min=1e-3, tables=tables, route="global", **kw)
        bare(run)()
        runs["global"] = [t, code, hit, *aux]
    tm = kw.pop("time")
    w = flat_out(bvh_ops.traverse_packed(*args[:4], tm, 1e-3, *args[4:], **kw))
    torch.cuda.synchronize(dev)
    stats = dict(variant=f"{case[7]} fold={int(fold)} full={int(full)} "
                 f"precomp={int(pre)}", rays=int(w[0].shape[0]),
                 hits=int(w[2].sum()))
    for route, g in runs.items():
        same = (g[2] == w[2]) & (g[1] == w[1])
        hit = w[2] & same
        st = dict(bit_equal=all(torch.equal(a, b) for a, b in zip(g, w)),
                  lanes_differ=int((~same).sum()),
                  max_abs_err_t=float((g[0] - w[0])[same].abs().max()),
                  max_abs_err_fold=max(
                      [float((a - b)[hit].abs().max())
                       for a, b in zip(g[3:], w[3:])] or [0.0]))
        diff = (g[0] - w[0])[same].abs()
        if not st["bit_equal"] and (float((~same).float().mean()) > FLIP_BUDGET
                                    or float(diff.median()) >= MEDIAN_MAX):
            raise AssertionError(f"K5 ({route} route) disagrees with its "
                                 f"plain version: {stats} {st}")
        stats[route] = st
    stats["bit_equal"] = all(stats[r]["bit_equal"] for r in runs)
    stats["max_abs_err_t"] = max(stats[r]["max_abs_err_t"] for r in runs)
    if not 0 < stats["hits"] < stats["rays"]:
        raise AssertionError(f"K5 comparison has no hits or no misses: {stats}")
    return stats


def k5_shapes(case, fold, full, pre, dev, launches=20):
    """K5 alone on one case (``graph_ms``) at each block size of ``BLOCKS``:
    {block: ms}."""
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    args, kw = k5_args(case, dev)
    tables = bvh_kernel.pack_tables(args[0], args[1], case[7], pre)
    return {blk: round(graph_ms(lambda: bvh_kernel.prepare_launch(
        *args, t_min=1e-3, fold_record=fold, fold_full=full, precomp=pre,
        tables=tables, block=blk, **kw)[0], dev, launches, 3)[0], 5)
        for blk in BLOCKS}


def threefry_draws_timings(dev, widths=(388800, 6144)):
    """The draws kernel's device time a launch (``graph_ms``) at each width,
    with a [B] and an int bounce, beside its bound and the plain version's
    device time; each launch's uniforms bit-equal to the plain version's."""
    import torch

    from another_raytracer_tpu_torch.ops import rng
    from another_raytracer_tpu_torch.ops.kernels import threefry_kernel

    g = torch.Generator(device="cpu").manual_seed(8)
    out = {}
    for n in widths:
        pix, samp = (torch.randint(0, 2**32, (n,), generator=g,
                                   dtype=torch.int64).to(dev)
                     for _ in range(2))
        bounces = torch.randint(0, 51, (n,), generator=g,
                                dtype=torch.int64).to(dev)
        seed = torch.tensor(0x9E3779B9, device=dev)
        for kind, bounce in (("bounce [B]", bounces),
                             ("bounce int", rng.CAMERA_BOUNCE)):
            args = (seed, pix, samp, bounce, rng.DIM_SCATTER_A)
            run, got = threefry_kernel.prepare_launch(*args)
            bare(run)()
            if not all(torch.equal(a, b) for a, b in
                       zip(got, rng.uniform2_plain(*args))):
                raise AssertionError(f"the draws kernel differs from its "
                                     f"plain version ({n} lanes, {kind})")

            def plain(args=args):
                def go():
                    rng.uniform2_plain(*args)
                    return 0
                return go

            ms = graph_ms(lambda: threefry_kernel.prepare_launch(*args)[0],
                          dev)[0]
            in_bytes = 8 * (3 if kind == "bounce [B]" else 2)
            b_ms, b_by = bound(n * OPS_DRAWS, n * (in_bytes + 8) + 8)
            out[f"{n} lanes, {kind}"] = dict(
                ms=round(ms, 5), bound_ms=round(b_ms, 5), bound_by=b_by,
                share_of_bound=round(b_ms / ms, 4),
                plain_ms=round(graph_ms(plain, dev, 10)[0], 5))
    return out


def bounce_timings(scenes, dev, widths=(388800, 48640, 6144)):
    """The bounce kernel's device time a launch (``graph_ms``) at each
    width, on the first step of each scene of ``scenes`` ({name: (scene,
    camera parameters)}: W x H camera rays, all lanes alive, K5 run once
    before), its carry bit-equal to the eager step's followed by the
    re-arm (``max_abs_err``, the largest gap over the carry's tensors);
    beside its bytes bound (the carry, the pixels and K5's outputs read,
    the carry written, time too: the launch writes a new carry), the
    re-armed lanes' share, the eager step's and re-arm's time (its plain
    version, K5 included) and K5's over the same lanes, all by
    ``graph_ms``."""
    import torch

    from another_raytracer_tpu_torch.ops import bvh as bvh_ops
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import integrator, intersect
    from another_raytracer_tpu_torch.ops.kernels import bounce_kernel

    out = {}
    for name, (sc, cp) in scenes.items():
        cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cp)
        for n in widths:
            pix = torch.arange(n, device=dev) % (W * H)
            samp0 = torch.arange(n, device=dev) // (W * H)
            args = (sc, cam, pix, 5, W, H, 1, TEX_SPP, DEPTH, 1e-3)
            cam_rays, e_step, e_rearm = integrator._eager_step_parts(*args)
            state = integrator._regen_initial_state(cam_rays, samp0, TEX_SPP)
            fold = intersect.fold_tree(sc, n)
            init = (torch.full((n,), intersect.BIG, device=dev),
                    torch.full((n,), -1, dtype=torch.int32, device=dev))

            def k5(state=state, fold=fold, init=init):
                return intersect.tree_winners(sc, *state[:3], 1e-3, fold,
                                              init)

            winners = k5()
            kw = dict(fold=fold, sample_stride=1, limit=TEX_SPP,
                      max_depth=DEPTH, t_min=1e-3,
                      camera=bounce_kernel.camera_fields(cam, W, H,
                                                         sc.has_motion))

            def prepare(state=state, pix=pix, winners=winners, kw=kw):
                return bounce_kernel.prepare_launch(sc, state, pix, 5,
                                                    winners, **kw)[0]

            run, got = bounce_kernel.prepare_launch(sc, state, pix, 5,
                                                    winners, **kw)
            bare(run)()
            want, regen, _ = e_step(state)
            want = e_rearm(want, regen)
            pairs = list(zip(integrator._flatten(got),
                             integrator._flatten(want)))
            gap = max(float((a.double() - b.double()).abs().max())
                      for a, b in pairs)
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(f"the bounce kernel differs from the "
                                     f"eager step ({name}, {n} lanes): "
                                     f"max abs err {gap}")

            def calls(fn):
                def go():
                    fn()
                    return 0
                return lambda: go

            flat = integrator._flatten(state)
            aux = 0 if winners is None or winners[2] is None else (
                bvh_ops.n_aux(fold, True, fold == "planar") * 4 * n)
            k5_bytes = 0 if winners is None else 8 * n + aux
            nbytes = (2 * sum(t.nbytes for t in flat[:-1]) + pix.nbytes
                      + k5_bytes)
            b_ms, b_by = bound(0, nbytes)
            ms = graph_ms(prepare, dev)[0]
            out[f"{name}, {n} lanes"] = dict(
                fold=fold, max_abs_err=gap, ms=round(ms, 5),
                rearmed=round(float(regen.float().mean()), 4),
                bound_ms=round(b_ms, 5),
                bound_by=b_by, share_of_bound=round(b_ms / ms, 4),
                k5_ms=(None if winners is None
                       else round(graph_ms(calls(k5), dev, 20)[0], 5)),
                eager_step_ms=round(graph_ms(
                    calls(lambda: e_rearm(*e_step(state)[:2])), dev,
                    5)[0], 5))
    return out


def plain_k5(nodes, rows, o, d, init_t, init_idx, *, leaf_size, t_min=1e-3,
             prim="planar", time=None, fold_record=False, fold_full=False,
             precomp=False, tables=None):
    """K5's plain version behind the wrapper's signature (it walks the wide
    rows; ``tables`` is not read)."""
    from another_raytracer_tpu_torch.ops import bvh as bvh_ops

    return bvh_ops.traverse_packed(
        nodes, rows, o, d, time, t_min, init_t, init_idx, leaf_size=leaf_size,
        prim=prim, fold_record=fold_record, fold_full=fold_full,
        precomp=precomp)


@contextlib.contextmanager
def plain_wavefront():
    """Run the wavefront's bounces through the eager step (the bounce
    kernel's plain version) with K5's, K4's and the draws kernel's plain
    versions (on the card), eagerly: the plain walk reads the card, which no
    CUDA graph may capture.  The plain versions count no launch."""
    from another_raytracer_tpu_torch.ops import integrator, rng, shade
    from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel,
                                                         perlin_kernel,
                                                         threefry_kernel)

    saved = (bvh_kernel.bvh_closest_hit, perlin_kernel.perlin_noise,
             threefry_kernel.uniform2, integrator.GRAPHS,
             integrator._regen_step_parts)
    bvh_kernel.bvh_closest_hit = plain_k5
    perlin_kernel.perlin_noise = shade.perlin_noise
    threefry_kernel.uniform2 = rng.uniform2_plain
    integrator.GRAPHS = {}
    integrator._regen_step_parts = integrator._eager_step_parts
    try:
        yield
    finally:
        (bvh_kernel.bvh_closest_hit, perlin_kernel.perlin_noise,
         threefry_kernel.uniform2, integrator.GRAPHS,
         integrator._regen_step_parts) = saved


def reset_counts():
    """Every kernel's launch count to 0."""
    from another_raytracer_tpu_torch.ops import kernels

    kernels.reset_launch_counts()


def counts():
    """{kernel: launches} since the last ``reset_counts``."""
    from another_raytracer_tpu_torch.ops import kernels

    return kernels.launch_counts()


def run_cli(scene, width, height, spp, depth, tmp, mode="single", obj=None):
    """The CLI on the card (``obj``: its ``--obj``); returns (rc, stdout,
    image, {kernel: launches in this run})."""
    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.utils import imageio

    out = os.path.join(tmp, f"scene{scene}_{mode}.png")
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--scene", str(scene), "--width", str(width),
                       "--height", str(height), "--spp", str(spp),
                       "--max-depth", str(depth), "--mode", mode,
                       "--device", "cuda", "--out", out]
                      + ([] if obj is None else ["--obj", obj]))
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


def media_phases(dev, mesh_dir):
    """The media and mesh phases (scenes 7, 8 and 9 through ``--obj``):
    the wavefront through the kernels against their plain versions, the
    CLI renders, profiler traces, K5 alone on the mesh's first call and a
    lockstep gradient step on scene 7.  Returns what the ``kernels`` line
    reports of them."""
    import torch

    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import bvh as bvh_ops
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import integrator
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    obj = write_capsule(mesh_dir)
    scenes = {7: library.cornell_smoke(device=dev),
              8: library.final_scene(device=dev),
              9: library.mesh_scene(obj_path=obj, device=dev)}
    mesh = scenes[9][0]
    tables = mesh.k5_tables("planar", True)
    mesh_route = bvh_kernel.table_route(tables)
    phase("media_scenes", f"scene 7: {scenes[7][0].n_rects} rects, "
          f"{scenes[7][0].n_media} media; scene 8: {scenes[8][0].n_rects} "
          f"rects (tree of {scenes[8][0].n_rect_bvh_nodes} nodes), "
          f"{scenes[8][0].n_spheres} spheres (tree of "
          f"{scenes[8][0].n_sph_bvh_nodes} nodes), {scenes[8][0].n_media} "
          f"media, leaf {scenes[8][0].bvh_leaf_size}; mesh {obj}: "
          f"{mesh.n_triangles} triangles, {mesh.n_bvh_nodes} nodes, K5 tables "
          f"{tables.numel() * 4} B (shared-memory limit "
          f"{bvh_kernel.MAX_SMEM} B), route {mesh_route!r}")
    if mesh_route != "global" or mesh.n_triangles != 5760:
        raise AssertionError("the mesh's K5 tables must take the "
                             "device-memory route")

    def untouched(launched, what):
        if any(launched[k] for k in ("K1", "K2", "K3", "K3_record",
                                     "K3_global", "K3_record_global",
                                     "replay")):
            raise AssertionError(f"{what} reached the megakernel or the "
                                 f"replay: {launched}")

    # The wavefront through K5 and the bounce kernel against the eager step
    # through K5's, K4's and the draws kernel's plain versions: each is
    # bit-equal to its plain version, so the sums and segments must be
    # equal.  The bounce kernel evaluates the noise itself: K4 launches
    # nothing on the wavefront.
    wkw = dict(width=MW, height=MH, sample_start=0, n_samples=MSPP,
               spp_cap=MSPP, samples_per_pass=1, max_depth=MDEPTH, t_min=1e-3)
    want_trees = {7: set(), 8: {"rect/shared", "sphere/shared"},
                  9: {"planar/global"}}
    compare = {}
    for sid, (sc, cp) in scenes.items():
        cam = camera_lib.make_camera(aspect_ratio=MW / MH, device=dev, **cp)
        pix = torch.arange(MW * MH, device=dev)
        reset_counts()
        got, got_segs = render_lib.radiance_batch(sc, cam, pix, 7, **wkw)
        launched = counts()
        with plain_wavefront():
            ref, ref_segs = render_lib.radiance_batch(sc, cam, pix, 7, **wkw)
        torch.cuda.synchronize(dev)
        equal = (all(torch.equal(a, b) for a, b in zip(got, ref))
                 and int(got_segs) == int(ref_segs))
        st = dict(bit_equal=equal, segments=int(got_segs),
                  max_abs_err=max(float((a - b).abs().max())
                                  for a, b in zip(got, ref)),
                  K5=launched["K5"], K5_by_tree=launched["K5_by_tree"],
                  K4=launched["K4"], draws=launched["draws"],
                  bounce=launched["bounce"])
        untouched(launched, f"scene {sid}")
        if (not equal or set(launched["K5_by_tree"]) != want_trees[sid]
                or launched["K4"] or launched["draws"] < 1
                or launched["bounce"] < 1):
            raise AssertionError(f"scene {sid}: the wavefront through the "
                                 f"kernels against their plain versions: {st}")
        compare[sid] = st
        phase("compare_media", f"scene {sid} {MW}x{MH} spp{MSPP} "
              f"depth{MDEPTH}: {json.dumps(st)}")

    # The CLI at the README size, spp TEX_SPP: scenes 7 and 8 in single
    # mode, the mesh in adaptive (the CLI's default) and single mode.
    renders = {}
    for sid, mode in ((7, "single"), (8, "single"), (9, "adaptive"),
                      (9, "single")):
        with tempfile.TemporaryDirectory() as tmp:
            rc, out, img, launched = run_cli(sid, W, H, TEX_SPP, DEPTH, tmp,
                                             mode, obj if sid == 9 else None)
        wall_ms, mrays, segs = cli_stats(out)
        untouched(launched, f"the scene-{sid} CLI render")
        if (rc != 0 or segs != MEDIA_SEGMENTS[f"scene {sid} {mode}"]
                or img.shape != (H, W, 3) or img.mean() < 2.0
                or set(launched["K5_by_tree"]) != want_trees[sid]
                or launched["K4"] or launched["bounce"] < 1):
            raise AssertionError(f"main path (scene {sid}, {mode}): rc={rc} "
                                 f"{launched}, {segs} segments, PNG mean "
                                 f"{img.mean():.2f}")
        renders[f"scene {sid} {mode}"] = dict(
            ms=wall_ms, segments=segs, mrays_per_s=mrays, K5=launched["K5"],
            K5_by_tree=launched["K5_by_tree"], K4=launched["K4"],
            draws=launched["draws"], bounce=launched["bounce"],
            png_mean=round(float(img.mean()), 2))
        phase("main_path_media", f"scene {sid} {W}x{H} spp{TEX_SPP} "
              f"depth{DEPTH} {mode} (CLI): "
              f"{json.dumps(renders[f'scene {sid} {mode}'])}")

    # Where the scene-8 and mesh renders' time goes: profiler traces at
    # spp 1.
    profiles = {}
    for sid in (8, 9):
        wall_ms, busy_ms, n_kern, launched, top = profile_render(
            scenes[sid][0], scenes[sid][1], 1, dev)
        k5_ms = sum(ms for nm, ms, _ in top if "bvh_kernel" in nm)
        bounce_ms = sum(ms for nm, ms, _ in top if "bounce_kernel" in nm)
        profiles[sid] = dict(wall_ms=round(wall_ms, 1),
                             busy_ms=round(busy_ms, 2),
                             busy_share=round(busy_ms / wall_ms, 4),
                             device_ops=n_kern, K5_launches=launched["K5"],
                             bounce_launches=launched["bounce"],
                             draws_launches=launched["draws"],
                             K5_ms=round(k5_ms, 3),
                             bounce_ms=round(bounce_ms, 3),
                             K5_share=round(k5_ms / busy_ms, 4),
                             bounce_share=round(bounce_ms / busy_ms, 4))
        phase("profile_media", f"scene {sid} {W}x{H} spp1 depth{DEPTH}: "
              f"{json.dumps(profiles[sid])}; top by device time: "
              + "; ".join(f"{nm} {ms:.1f} ms / {c}" for nm, ms, c in top[:6]))

    # K5 on scene 8's first call against its plain version: the 388,800
    # camera rays against the rect tree and the sphere tree (leaf 48), each
    # in the variant the wavefront gives it at this width.
    sc8, cp8 = scenes[8]
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cp8)
    pix, samp = lanes(W, H, dev)
    o, d, tm = camera_lib.generate_rays(cam, pix, samp, W, H, 0,
                                        needs_time=sc8.has_motion)
    scene8_first = {}
    for prim, nodes, rows in (
            ("rect", sc8.rect_bvh_nodes, sc8.rect_bvh_rows),
            ("sphere", sc8.sph_bvh_nodes, sc8.sph_bvh_rows)):
        case = (f"scene 8's first call, {prim} tree", nodes, rows, list(o),
                list(d), tm, sc8.bvh_leaf_size, prim)
        cmp = compare_k5(case, *k5_main(prim, sc8), dev)
        if not cmp["bit_equal"]:
            raise AssertionError(f"K5 on scene 8's {prim} tree differs from "
                                 f"its plain version: {cmp}")
        scene8_first[prim] = cmp
        phase("compare_k5_scene8", f"K5 on scene 8's first call ({W * H} "
              f"camera rays, {prim} tree of {nodes.shape[0]} nodes, leaf "
              f"{sc8.bvh_leaf_size}): {json.dumps(cmp)}")

    # K5 alone on the mesh's first call: 388,800 camera rays against the
    # planar tree on device memory, the wavefront's variant (the full fold
    # on precomputed geometry: the width is above the fold's gate).
    fold, full, pre = k5_main("planar", mesh)
    if not fold:
        raise AssertionError("the timed K5 call is below the fold's gate")
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev,
                                 **scenes[9][1])
    pix, samp = lanes(W, H, dev)
    o, d, tm = camera_lib.generate_rays(cam, pix, samp, W, H, 0)
    case = ("the mesh's first call", mesh.bvh_packed_nodes,
            mesh.bvh_packed_tris, list(o), list(d), tm, mesh.bvh_leaf_size,
            "planar")
    cmp = compare_k5(case, fold, full, pre, dev)
    if not cmp["bit_equal"]:
        raise AssertionError(f"K5 on the mesh differs from its plain "
                             f"version: {cmp}")
    work = k5_work(case, fold, full, pre, dev)
    _, slabs, tests, hits, b_ms, b_by = work
    tl = k5_tallies(case, fold, full, pre, dev, work=work)
    args, kw = k5_args(case, dev)
    ms = graph_ms(lambda: bvh_kernel.prepare_launch(
        *args, t_min=1e-3, fold_record=fold, fold_full=full, precomp=pre,
        tables=tables, **kw)[0], dev, 20)[0]
    tmk = kw.pop("time")
    plain_ms = cuda_ms(lambda: bvh_ops.traverse_packed(
        *args[:4], tmk, 1e-3, *args[4:], fold_record=fold, fold_full=full,
        precomp=pre, **kw), dev, 1)[0]
    kw["time"] = tmk
    first = dict(rays=W * H, route=mesh_route, table_bytes=tables.numel() * 4,
                 ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 share_of_bound=b_ms / ms, slab_tests=slabs, leaf_tests=tests,
                 hits=hits, bit_equal=cmp["bit_equal"],
                 tallies={k: tl[k] for k in ("slab_simt", "leaf_simt",
                                             "tail_share", "blocks",
                                             "launch_ms")},
                 block_ms=k5_shapes(case, fold, full, pre, dev))
    phase("timing_k5_mesh", f"K5 on the mesh's first call ({W * H} camera "
          f"rays, {mesh.n_triangles} triangles, planar fold={int(fold)} "
          f"full={int(full)} precomp={int(pre)}, block {bvh_kernel.BLOCK}): "
          f"{json.dumps(first)}")

    # One lockstep gradient step on scene 7 with the media densities
    # trainable: the loss against a render at other densities.
    smoke, cp = scenes[7]
    cam = camera_lib.make_camera(aspect_ratio=GW / GH, device=dev, **cp)
    gkw = dict(width=GW, height=GH, spp=GSPP, samples_per_pass=1,
               max_depth=GDEPTH, t_min=1e-3)
    with torch.no_grad():
        acc, _ = render_lib.render_radiance(smoke.replace(
            med_neg_inv_density=smoke.med_neg_inv_density * 0.5), cam, 1,
            **gkw)
    target = torch.stack(tuple(acc), -1) / GSPP
    params = {"med_neg_inv_density": smoke.med_neg_inv_density}
    calls = []
    real = integrator.trace
    integrator.trace = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        reset_counts()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        loss, grads = diff.render_value_and_grad(params, smoke, cam, target, 1,
                                                 **gkw)
        torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t) * 1e3
        launched = counts()
    finally:
        integrator.trace = real
    # The media's albedos are solid colours and their scatter directions do
    # not depend on the scatter point, so the radiance is piecewise constant
    # in the densities: the gradient is finite and zero, as JAX's.
    g = grads["med_neg_inv_density"]
    untouched(launched, "the media gradient step")
    if (not calls or not bool(torch.isfinite(loss)) or g.device != loss.device
            or g.device.type != "cuda" or not bool(torch.isfinite(g).all())):
        raise AssertionError(f"media gradient step: loss {loss}, gradient "
                             f"{g}, lockstep calls {len(calls)}")
    grad = dict(ms=round(step_ms, 1), loss=float(loss),
                gradient=[float(x) for x in g])
    phase("media_gradient", f"scene 7 {GW}x{GH} spp{GSPP} depth{GDEPTH}, "
          f"med_neg_inv_density trainable, lockstep on the card: "
          f"{json.dumps(grad)}")
    # The bounce kernel alone on scene 8's and the mesh's first step at the
    # first, a middle and the narrowest stage width.
    bounce = bounce_timings({"scene 8": scenes[8], "mesh": scenes[9]}, dev)
    phase("timing_bounce", f"bounce kernel: {json.dumps(bounce)}")
    return dict(compare=compare, renders=renders, profiles=profiles,
                scene8_first_call=scene8_first, mesh_first_call=first,
                gradient=grad, bounce=bounce)


def host_library_phase():
    """Build the host library (csrc/host) with the host C++ compiler; one
    line of its own: the path, the compiler and the seconds."""
    from another_raytracer_tpu_torch.utils import native

    path, secs = native.build()
    line = {"library": path.name, "compiler": native.compiler(),
            "flags": list(native.FLAGS), "build_s": round(secs, 1),
            "sources": [str(s.relative_to(s.parents[2])) for s in
                        native.SOURCES]}
    phase("host_library", json.dumps(line))
    return line


def pixels_differ(a, b):
    """Share of the pixels whose uint8 colours differ."""
    return float((np.asarray(a) != np.asarray(b)).any(-1).mean())


def modes_phase(dev, cornell, cornell_cam, scene1, cam1, tmp):
    """The README render in the stripes and images modes (through the CLI
    on the visible devices, and over 4-way splits of the card) against
    single mode; 8 sample shards at spp 4; scene 1 in 4-way stripes through
    K3.  Returns {split: stats}."""
    import torch

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.parallel import sharding

    out = {}
    # The user's entry point: the CLI in both parallel modes on the visible
    # devices, against the CLI's single render.
    imgs = {}
    for mode in ("single", "parallel_stripes", "parallel_images"):
        rc, stdout, imgs[mode], launched = run_cli(6, W, H, SPP, DEPTH, tmp,
                                                   mode)
        wall_ms, _, segs = cli_stats(stdout)
        n_dev = torch.cuda.device_count() if mode != "single" else 1
        if rc != 0 or launched["K1"] != n_dev or segs <= 0:
            raise AssertionError(f"CLI {mode}: rc={rc} {launched}\n{stdout}")
        out[f"cli {mode}"] = {"wall_ms": wall_ms, "segments": segs,
                              "launches": launched["K1"]}
    for mode in ("parallel_stripes", "parallel_images"):
        if out[f"cli {mode}"]["segments"] != out["cli single"]["segments"]:
            raise AssertionError(f"CLI {mode}: segments differ from single")
        share = pixels_differ(imgs[mode], imgs["single"])
        limit = 0.0 if mode == "parallel_stripes" else 1e-3
        if share > limit:
            raise AssertionError(f"CLI {mode}: {share:.2e} of the pixels "
                                 "differ from single mode")
        out[f"cli {mode}"]["pixels_differ"] = share
    phase("modes", f"CLI cornell {W}x{H} spp{SPP} depth{DEPTH} on "
          f"{torch.cuda.device_count()} visible device(s): "
          f"{json.dumps({k: v for k, v in out.items()})}")

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    kw = dict(width=W, height=H, spp=SPP, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)
    ref, ref_segs = render_lib.render_radiance(cornell, cam, 0, **kw)
    ref = torch.stack(tuple(ref), 1)
    ref_img = color_uint8(ref, SPP)
    single_ms, single_runs = cuda_ms(
        lambda: render_lib.render_radiance(cornell, cam, 0, **kw), dev, 5)
    out["single"] = {"ms": single_ms, "runs": single_runs,
                     "segments": int(ref_segs)}
    for n_tile, n_spp in ((4, 1), (1, 4), (2, 2)):
        part = sharding.hybrid_partition(n_tile, n_spp, devices=[dev] * 4)
        reset_counts()
        acc, segs = sharding.render_radiance_sharded(cornell, cam, 0,
                                                     partition=part, **kw)
        launched = counts()
        got = torch.stack(tuple(acc), 1)
        if launched["K1"] != 4 or int(segs) != int(ref_segs):
            raise AssertionError(f"{n_tile}x{n_spp}: launches {launched}, "
                                 f"segments {int(segs)} vs {int(ref_segs)}")
        if n_spp == 1:
            ok = torch.equal(got, ref)
        else:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
        share = pixels_differ(color_uint8(got, SPP), ref_img)
        if not ok or share >= 1e-3:
            raise AssertionError(f"{n_tile}x{n_spp}: max |diff| "
                                 f"{float((got - ref).abs().max())}, "
                                 f"{share:.2e} of the pixels differ")
        ms, runs = cuda_ms(lambda: sharding.render_radiance_sharded(
            cornell, cam, 0, partition=part, **kw), dev, 5)
        out[f"{n_tile}x{n_spp}"] = {
            "ms": ms, "runs": runs, "vs_single": ms / single_ms,
            "launches": launched["K1"], "bit_equal": bool(torch.equal(got, ref)),
            "max_abs_err": float((got - ref).abs().max()),
            "pixels_differ": share}
        phase("modes", f"cornell {W}x{H} spp{SPP} over [cuda:0] x 4 as "
              f"{n_tile}x{n_spp}: {json.dumps(out[f'{n_tile}x{n_spp}'])}; "
              f"single {single_ms:.3f} ms")

    # 8 sample shards at spp 4: shards 4-7 start past the cap; every lane
    # is born dead and their sums are zero.
    kw4 = dict(kw, spp=4)
    ref4, ref4_segs = render_lib.render_radiance(cornell, cam, 0, **kw4)
    part = sharding.hybrid_partition(1, 8, devices=[dev] * 8)
    reset_counts()
    acc, segs = sharding.render_radiance_sharded(cornell, cam, 0,
                                                 partition=part, **kw4)
    launched = counts()
    pix = torch.arange(W * H, device=dev)
    empty = []
    for k in range(4, 8):
        e_acc, e_segs = render_lib.radiance_batch(
            cornell, cam, pix, 0, width=W, height=H, sample_start=k,
            n_samples=1, spp_cap=4, samples_per_pass=1, max_depth=DEPTH,
            t_min=1e-3)
        empty.append(int(e_segs) == 0 and all(bool((c == 0).all())
                                             for c in e_acc))
    got4 = torch.stack(tuple(acc), 1)
    ref4 = torch.stack(tuple(ref4), 1)
    if (launched["K1"] != 8 or int(segs) != int(ref4_segs) or not all(empty)
            or not torch.allclose(got4, ref4, rtol=1e-5, atol=1e-5)):
        raise AssertionError(f"1x8 at spp 4: launches {launched}, empty "
                             f"shards zero {empty}, segments {int(segs)} vs "
                             f"{int(ref4_segs)}")
    out["1x8 spp4"] = {"launches": launched["K1"], "empty_shards_zero": empty,
                       "max_abs_err": float((got4 - ref4).abs().max())}
    phase("modes", f"cornell {W}x{H} spp4 over 8 sample shards: "
          f"{json.dumps(out['1x8 spp4'])}")

    # Scene 1 in 4-way stripes through K3 (Morton chunks of the frame).
    cam1c = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    ref1, ref1_segs = render_lib.render_radiance(scene1, cam1c, 0, **kw)
    part = sharding.hybrid_partition(4, 1, devices=[dev] * 4)
    reset_counts()
    acc, segs = sharding.render_radiance_sharded(scene1, cam1c, 0,
                                                 partition=part, **kw)
    launched = counts()
    equal = all(torch.equal(a, b) for a, b in zip(acc, ref1))
    if not equal or launched["K3"] != 4 or int(segs) != int(ref1_segs):
        raise AssertionError(f"scene 1 stripes: bit-equal {equal}, launches "
                             f"{launched}, segments {int(segs)}")
    s1_ms, _ = cuda_ms(lambda: render_lib.render_radiance(scene1, cam1c, 0,
                                                          **kw), dev, 3)
    st_ms, _ = cuda_ms(lambda: sharding.render_radiance_sharded(
        scene1, cam1c, 0, partition=part, **kw), dev, 3)
    out["scene1 4x1"] = {"launches": launched["K3"], "bit_equal": equal,
                         "ms": st_ms, "single_ms": s1_ms}
    phase("modes", f"scene 1 {W}x{H} spp{SPP} in 4 stripes through K3: "
          f"{json.dumps(out['scene1 4x1'])}")
    return out


def color_uint8(radiance, spp):
    from another_raytracer_tpu_torch.ops import color as color_lib

    return color_lib.to_uint8(radiance, spp).cpu().numpy()


def adaptive_partition_phase(dev, cornell, cornell_cam):
    """Cornell adaptive at the README size over 4x1 and 2x2 partitions of
    the card against the one-device adaptive render."""
    import torch

    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
    from another_raytracer_tpu_torch.ops import adaptive
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.parallel import sharding

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, mode=RenderMode.ADAPTIVE)
    quiet = contextlib.redirect_stderr(io.StringIO())  # per-level progress
    torch.cuda.synchronize(dev)
    reset_counts()
    t = time.perf_counter()
    with quiet:
        one, st1 = adaptive.render_adaptive(cornell, cam, cfg)
    one_ms = (time.perf_counter() - t) * 1e3
    out = {"one_device_ms": one_ms, "traced": st1["traced_pixels"],
           "batches": st1["batches"], "launches": counts()["K1"]}
    # One K1 launch per traced batch on one device, one per shard per batch
    # over a partition.
    if out["launches"] != st1["batches"]:
        raise AssertionError(f"adaptive on one device: {json.dumps(out)}")
    for n_tile, n_spp in ((4, 1), (2, 2)):
        part = sharding.hybrid_partition(n_tile, n_spp, devices=[dev] * 4)
        reset_counts()
        t = time.perf_counter()
        with quiet:
            img, st = adaptive.render_adaptive(cornell, cam, cfg,
                                               partition=part)
        ms = (time.perf_counter() - t) * 1e3
        launched = counts()
        share = pixels_differ(img, one)
        out[f"{n_tile}x{n_spp}"] = {"ms": ms, "launches": launched["K1"],
                                    "pixels_differ": share,
                                    "traced": st["traced_pixels"],
                                    "batches": st["batches"]}
        # Stripes trace each pixel's samples in one lane: the same image.
        # A sample split adds the shards' float32 sums in another order, so
        # a work-frame colour on an integer boundary may move by one.
        if (launched["K1"] != st["batches"] * n_tile * n_spp
                or st["batches"] != st1["batches"]
                or (n_spp == 1 and share) or share >= 1e-3):
            raise AssertionError(f"adaptive over {n_tile}x{n_spp}: "
                                 f"{json.dumps(out)}")
    phase("adaptive_partition", f"cornell {W}x{H} spp{SPP} adaptive over "
          f"the card: {json.dumps(out)}")
    return out


def progressive_phase(dev, cornell, cornell_cam, tmp):
    """``render_progressive`` at the README size, samples_per_pass 1: an
    uninterrupted run with a checkpoint, the same to spp 50 and resumed to
    100 in a new call (bit-equal), against ``render.render``; timed without
    sinks and with a preview PNG every pass."""
    import torch

    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.utils import imageio, preview

    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, samples_per_pass=1)

    def timed_run(*sinks):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        img, st = preview.render_progressive(cornell, cam, *sinks)
        return img, st, (time.perf_counter() - t) * 1e3

    with contextlib.redirect_stderr(io.StringIO()):
        plain, _, plain_ms = timed_run(cfg)
        png = os.path.join(tmp, "preview.png")
        prev = preview.ProgressivePreview(png, W, H)
        with_png, _, png_ms = timed_run(cfg, prev)
        full = preview.RenderCheckpoint(os.path.join(tmp, "full.npz"))
        uninterrupted, _, full_ms = timed_run(cfg, None, full)
        part = preview.RenderCheckpoint(os.path.join(tmp, "part.npz"))
        reset_counts()
        _, _, half_ms = timed_run(cfg.replace(samples_per_pixel=SPP // 2),
                                  None, part)
        resumed, st, rest_ms = timed_run(cfg, None, part)
        launched = counts()
    single, _ = render_lib.render(cornell, cam, cfg)
    same = (np.array_equal(resumed, uninterrupted)
            and np.array_equal(part.load()["radiance"],
                               full.load()["radiance"])
            and np.array_equal(plain, uninterrupted)
            and np.array_equal(with_png, uninterrupted)
            and np.array_equal(imageio.load_png(png), uninterrupted))
    share = pixels_differ(resumed, single)
    out = {"plain_ms": plain_ms, "png_every_pass_ms": png_ms,
           "checkpoint_every_pass_ms": full_ms,
           "to_half_ms": half_ms, "resumed_ms": rest_ms,
           "resumed_at_chunk": st["resumed_at_chunk"],
           "launches": launched["K1"], "bit_equal": same,
           "pixels_differ_from_render": share, "passes": SPP,
           "ms_per_pass": plain_ms / SPP,
           "png_ms_per_pass": (png_ms - plain_ms) / SPP}
    if (not same or launched["K1"] != SPP or share >= 1e-3
            or st["resumed_at_chunk"] != SPP // 2):
        raise AssertionError(f"progressive: {json.dumps(out)}")
    phase("progressive", f"cornell {W}x{H} spp{SPP} depth{DEPTH}, one pass a "
          f"call: {json.dumps(out)}")
    return out


def cli_entry_phase(dev, tmp):
    """The CLI with --preview, --checkpoint and --profile-dir (single), and
    --live 0 (adaptive); a LiveViewer serving the final frame."""
    import urllib.request

    from another_raytracer_tpu_torch import cli
    from another_raytracer_tpu_torch.utils import imageio, profiling
    from another_raytracer_tpu_torch.utils.liveview import LiveViewer

    cw, ch, cspp = EW, EH, ESPP
    out, png, ckpt, trace = (os.path.join(tmp, n) for n in
                             ("cli.png", "cli_preview.png", "cli.npz",
                              "trace"))
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--scene", "6", "--width", str(cw), "--height",
                       str(ch), "--spp", str(cspp), "--max-depth", str(DEPTH),
                       "--mode", "single", "--preview", png, "--checkpoint",
                       ckpt, "--profile-dir", trace, "--out", out])
    launched = counts()
    wall_ms, _, segs = cli_stats(buf.getvalue())
    img = imageio.load_png(out)
    events = profiling.device_events(trace)
    k1_events = [e for e in events if "mega_forward_kernel" in e["name"]]
    busy_s = profiling.device_seconds(trace)
    ok = (rc == 0 and launched["K1"] == cspp and os.path.exists(ckpt)
          and np.array_equal(imageio.load_png(png), img)
          and len(k1_events) == cspp and busy_s > 0)
    stats = {"wall_ms": wall_ms, "segments": segs, "launches": launched["K1"],
             "trace_device_ms": busy_s * 1e3,
             "trace_k1_ms": sum(e["dur"] for e in k1_events) / 1e3,
             "trace_k1_events": len(k1_events),
             "checkpoint_samples": int(np.load(ckpt)["samples_done"])}
    if not ok:
        raise AssertionError(f"CLI with sinks: rc={rc} {json.dumps(stats)}\n"
                             f"{buf.getvalue()}")
    phase("cli_entry", f"--preview --checkpoint --profile-dir, cornell {cw}x"
          f"{ch} spp{cspp}: {json.dumps(stats)}")

    # --live 0 in adaptive mode (12 | width and height: EH rounded down).
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--scene", "6", "--width", str(cw), "--height",
                       str(ch - ch % 12),
                       "--spp", str(cspp), "--max-depth", str(DEPTH),
                       "--mode", "adaptive", "--live", "0", "--out", out])
    launched = counts()
    if rc != 0 or "live view at http://127.0.0.1:" not in buf.getvalue() \
            or launched["K1"] < 1:
        raise AssertionError(f"--live adaptive: rc={rc} {launched}\n"
                             f"{buf.getvalue()}")
    live_img = imageio.load_png(out)

    viewer = LiveViewer(port=0)
    viewer.start()
    try:
        viewer.update(live_img, cspp)
        with urllib.request.urlopen(viewer.url + "frame.png", timeout=10) as r:
            served = imageio._decode_png(r.read())
    finally:
        viewer.stop()
    if not np.array_equal(served, live_img):
        raise AssertionError("the live viewer served another frame")
    stats["live_adaptive_launches"] = launched["K1"]
    phase("cli_entry", f"--live 0 adaptive {cw}x{ch - ch % 12} spp{cspp}: "
          f"{cli_stats(buf.getvalue())[0]} ms, K1 launches {launched['K1']}; "
          f"/frame.png decodes to the final frame")
    return stats


def jpeg_phase(dev, tmp):
    """The host library's JPEG decoder on the committed samples, scene 8
    through the CLI with a JPEG earthmap, and a mesh with a JPEG map_Kd
    through the native parser."""
    import shutil

    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.models import mesh as mesh_lib
    from another_raytracer_tpu_torch.utils import imageio, native

    samples = os.path.join(os.path.dirname(native.__file__), "jpeg_samples")
    out = {}
    # Each sample against the JAX package's native decode of it (stored, bit
    # for bit; the chroma samples vary Cb and Cr, so the 4:2:0 path shows)
    # and the tinted ones against PIL's (stored, within the PIL bar).
    for name in ("baseline_420", "progressive", "chroma_420",
                 "chroma_progressive"):
        got = native.decode_jpeg(os.path.join(samples, f"{name}.jpg"))
        ref = imageio.load_png(os.path.join(samples, f"{name}.native.png"))
        out[name] = {"shape": list(got.shape),
                     "equals_native": bool(got.shape == ref.shape
                                           and np.array_equal(got, ref))}
        pil = os.path.join(samples, f"{name}.png")
        if os.path.exists(pil):
            want = imageio.load_png(pil)
            d = np.abs(got.astype(int) - want.astype(int))
            out[name].update(max_diff=int(d.max()), mean_diff=float(d.mean()))
            if d.max() > 4 or d.mean() >= 0.1:
                raise AssertionError(f"JPEG {name}: {out[name]}")
        if not out[name]["equals_native"]:
            raise AssertionError(f"JPEG {name}: {out[name]}")
    phase("jpeg", f"decodes against the stored native and PIL decodes: "
          f"{json.dumps(out)}")

    # Scene 8 with the baseline sample as its earthmap, and without (the
    # cyan fallback): the earth sphere's pixels carry the texture.
    assets_dir = os.path.join(tmp, "assets")
    os.makedirs(os.path.join(assets_dir, "textures"))
    shutil.copy(os.path.join(samples, "baseline_420.jpg"),
                os.path.join(assets_dir, "textures", "earthmap.jpg"))
    jw, jh, jspp = EW, EH, JSPP
    saved = os.environ.get("ARTPU_ASSETS")
    renders = {}
    try:
        for name, root in (("earthmap", assets_dir), ("cyan", None)):
            if root is None:
                os.environ.pop("ARTPU_ASSETS", None)
            else:
                os.environ["ARTPU_ASSETS"] = root
            with contextlib.redirect_stderr(io.StringIO()):
                rc, stdout, img, launched = run_cli(8, jw, jh, jspp, DEPTH,
                                                    tmp)
            renders[name] = (img, launched, cli_stats(stdout))
            if rc != 0 or launched["K5"] < 1 or launched["bounce"] < 1:
                raise AssertionError(f"scene 8 ({name}): rc={rc} {launched}")
    finally:
        if saved is None:
            os.environ.pop("ARTPU_ASSETS", None)
        else:
            os.environ["ARTPU_ASSETS"] = saved
    earth, cyan = renders["earthmap"][0].astype(int), renders["cyan"][0].astype(int)
    moved = (earth != cyan).any(-1)
    # Cyan has blue far above red; the tinted earthmap has red above blue.
    b_minus_r = {k: float((v[..., 2] - v[..., 0])[moved].mean())
                 for k, v in (("earthmap", earth), ("cyan", cyan))}
    out["scene8"] = {"wall_ms": renders["earthmap"][2][0],
                     "segments": renders["earthmap"][2][2],
                     "launches": {k: renders["earthmap"][1][k]
                                  for k in ("K5", "K4")},
                     "pixels_moved": int(moved.sum()),
                     "blue_minus_red_on_moved": b_minus_r}
    if moved.mean() < 1e-3 or b_minus_r["earthmap"] >= b_minus_r["cyan"]:
        raise AssertionError(f"scene 8's earth is not textured: {out['scene8']}")
    phase("jpeg", f"scene 8 {jw}x{jh} spp{jspp} depth{DEPTH} with a JPEG "
          f"earthmap: {json.dumps(out['scene8'])}")

    # A mesh whose map_Kd is a JPEG, through the native parser.
    mesh_dir = os.path.join(tmp, "jpeg_mesh")
    os.makedirs(mesh_dir)
    obj = write_capsule(mesh_dir, segments=32, rings=15, texels=16)
    shutil.copy(os.path.join(samples, "baseline_420.jpg"),
                os.path.join(mesh_dir, "checker.jpg"))
    with open(os.path.join(mesh_dir, "capsule.mtl"), "w") as f:
        f.write("newmtl checker\nKa 0 0 0\nKd 0.8 0.8 0.8\n"
                "map_Kd checker.jpg\n")
    got, want = mesh_lib.parse(obj), mesh_lib.parse(obj, native=False)
    same = (np.array_equal(got.tri_pos, want.tri_pos)
            and np.array_equal(got.tri_uv, want.tri_uv)
            and np.array_equal(got.tri_mat, want.tri_mat)
            and got.materials == want.materials)
    mesh, _ = library.mesh_scene(obj_path=obj, device=dev)
    out["mesh"] = {"triangles": got.num_triangles, "native_equals_python": same,
                   "map_texels": [int(mesh.img_h[0]), int(mesh.img_w[0])]}
    if not same or out["mesh"]["map_texels"] != [64, 128]:
        raise AssertionError(f"mesh with a JPEG map: {out['mesh']}")
    phase("jpeg", f"mesh with a JPEG map_Kd: {json.dumps(out['mesh'])}")
    return out


def multihost_worker(rank, world, port, outdir, device, size):
    """One of the ``multihost`` phase's processes: its stripes of the
    Cornell frame at ``size`` (width, height, spp, depth) on ``device``,
    gathered over gloo."""
    import torch

    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.parallel import multihost

    width, height, spp, depth = size
    dev = torch.device(device)
    multihost.initialize("gloo", f"tcp://127.0.0.1:{port}", world, rank)
    scene, params = library.cornell_box(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=width / height, device=dev,
                                 **params)
    t = time.perf_counter()
    frame, segments = multihost.render_radiance_multihost(
        scene, cam, 0, width=width, height=height, spp=spp,
        samples_per_pass=1, max_depth=depth, t_min=1e-3)
    ms = (time.perf_counter() - t) * 1e3
    np.save(os.path.join(outdir, f"frame_{rank}.npy"), frame)
    with open(os.path.join(outdir, f"stats_{rank}.json"), "w") as f:
        json.dump({"segments": segments, "ms": ms}, f)
    torch.distributed.destroy_process_group()


def multihost_phase(dev, cornell, cornell_cam, tmp):
    """Two processes share the card over gloo; each renders its stripes and
    both gather the frame, bit-equal to the one-process render."""
    import multiprocessing
    import socket

    import torch

    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.ops import render as render_lib

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=multihost_worker,
                         args=(r, 2, port, tmp, str(dev),
                               (W, H, MH_SPP, DEPTH))) for r in range(2)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MH_TIMEOUT)
            if p.is_alive() or p.exitcode != 0:
                raise AssertionError(f"multihost rank failed or hung "
                                     f"(exit code {p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    wall_ms = (time.perf_counter() - t) * 1e3
    frames = [np.load(os.path.join(tmp, f"frame_{r}.npy")) for r in range(2)]
    stats = []
    for r in range(2):
        with open(os.path.join(tmp, f"stats_{r}.json")) as f:
            stats.append(json.load(f))
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    ref, segs = render_lib.render_radiance(
        cornell, cam, 0, width=W, height=H, spp=MH_SPP, samples_per_pass=1,
        max_depth=DEPTH, t_min=1e-3)
    ref = torch.stack(tuple(ref), 1).cpu().numpy()
    ok = (np.array_equal(frames[0], frames[1])
          and np.array_equal(frames[0], ref)
          and stats[0]["segments"] == stats[1]["segments"] == int(segs))
    out = {"ranks": 2, "backend": "gloo", "bit_equal": ok,
           "render_ms": [st["ms"] for st in stats], "wall_ms": wall_ms,
           "segments": stats[0]["segments"]}
    if not ok:
        raise AssertionError(f"multihost: {json.dumps(out)}")
    phase("multihost", f"cornell {W}x{H} spp{MH_SPP} depth{DEPTH} in two "
          f"processes on one card: {json.dumps(out)}")
    return out


def sharded_step_phase(dev, cornell, cornell_cam):
    """The sharded training step at the bench size: over 4x1 (K2 and the
    replay per shard) and the ragged 7x1 (97,200 pixels: six chunks of
    13,886 and one of 13,884, each on the fused path, unpadded) against the
    unsharded fused step, over 1x2 (the lockstep path) against the
    unsharded lockstep step; one adam update."""
    import torch

    from another_raytracer_tpu_torch.grad import diff
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.parallel import sharding

    cam = camera_lib.make_camera(aspect_ratio=BW / BH, device=dev,
                                 **cornell_cam)
    kw = dict(width=BW, height=BH, spp=BSPP, samples_per_pass=1,
              max_depth=BDEPTH, t_min=1e-3)
    target = torch.zeros((BW * BH, 3), device=dev)
    params, _ = diff.split_params(cornell)

    def worst(got, want):
        """Largest |diff| over each leaf's scale."""
        return max(float((got[k] - want[k]).abs().max())
                   / max(float(want[k].abs().max()), 1e-30) for k in want)

    out = {}
    for (n_tile, n_spp), flag, path in (((4, 1), None, "fused"),
                                        ((7, 1), None, "fused"),
                                        ((1, 2), False, "lockstep")):
        part = sharding.hybrid_partition(n_tile, n_spp,
                                         devices=[dev] * (n_tile * n_spp))
        with fused(flag):
            loss_u, g_u = diff.render_value_and_grad(params, cornell, cam,
                                                     target, 0, **kw)
            reset_counts()
            loss_s, g_s = diff.render_value_and_grad(
                params, cornell, cam, target, 0, partition=part, **kw)
            launched = counts()
            ms_u, _ = cuda_ms(lambda: diff.render_value_and_grad(
                params, cornell, cam, target, 0, **kw), dev, 3)
            ms_s, _ = cuda_ms(lambda: diff.render_value_and_grad(
                params, cornell, cam, target, 0, partition=part, **kw), dev, 3)
        loss_rel = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
        grad_rel = worst(g_s, g_u)
        want = (n_tile, n_tile) if path == "fused" else (0, 0)
        stats = {"path": path, "loss_rel": loss_rel, "grad_rel": grad_rel,
                 "K2": launched["K2"], "replay": launched["replay"],
                 "ms": ms_s, "unsharded_ms": ms_u}
        out[f"{n_tile}x{n_spp}"] = stats
        if ((launched["K2"], launched["replay"]) != want or loss_rel > 1e-5
                or grad_rel > 1e-5):
            raise AssertionError(f"sharded step {n_tile}x{n_spp}: "
                                 f"{json.dumps(stats)}")
    part = sharding.hybrid_partition(4, 1, devices=[dev] * 4)
    state, step = diff.make_train_step(cornell, cam, target, partition=part,
                                       **kw)
    state, loss = step(state, 0)
    finite = all(bool(torch.isfinite(v).all()) for v in state.params.values())
    out["adam"] = {"loss": float(loss), "params_finite": finite}
    if not finite or not np.isfinite(float(loss)):
        raise AssertionError(f"sharded adam step: {out['adam']}")
    phase("sharded_step", f"cornell {BW}x{BH} spp{BSPP} depth{BDEPTH}: "
          f"{json.dumps(out)}")
    return out


def train_demo_phase(dev):
    """The inverse-rendering demos at the chip configuration, to the
    scripts' chip criteria: Cornell for DEMO_STEPS steps through its entry
    point (the ``main`` of ``python -m another_raytracer_tpu_torch.
    train_demo``; K2 and the replay once a step and once for the floor),
    then the atlas's DEMO_STEPS steps through ``atlas_demo`` and ``run`` at
    samples_per_pass = spp (the scripts' samples in one pass, on the
    lockstep path: no kernel but the draws).  Returns {demo: {"record": its record,
    "launches": every kernel's launches over the demo, as checked}}."""
    from another_raytracer_tpu_torch import train_demo

    def cornell():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_demo.main(["--steps", str(DEMO_STEPS)])
        return rc, json.loads(buf.getvalue().strip().splitlines()[-1])

    def atlas():
        demo = train_demo.atlas_demo(
            dev, samples_per_pass=train_demo.ATLAS["chip"][2])
        return 0, train_demo.run(demo, DEMO_STEPS, False, log=lambda *a: None)

    out = {}
    for name, drive in (("cornell", cornell), ("atlas", atlas)):
        reset_counts()
        rc, rec = drive()
        launched = {k: v for k, v in counts().items() if k != "K5_by_tree"}
        # The route is every kernel but the draws, which the demos' lockstep
        # renders (the Cornell target, the atlas's steps) launch too.
        want = {k: 0 for k in launched if k != "draws"}
        if name == "cornell":
            want.update(K2=DEMO_STEPS + 1, replay=DEMO_STEPS + 1)
        if (rc != 0 or not rec["passed"]
                or {k: launched[k] for k in want} != want):
            raise AssertionError(f"train_demo {name}: rc {rc}, launches "
                                 f"{json.dumps(launched)}, record "
                                 f"{json.dumps(rec)}")
        out[name] = {"record": rec, "launches": launched}
        phase("train_demo", f"{name}: {rec['config']}, samples_per_pass "
              f"{rec['samples_per_pass']}, {DEMO_STEPS} steps in "
              f"{rec['seconds']:.2f} s ({rec['ms_per_step']:.3f} ms a "
              f"step); loss {rec['loss_curve'][0][1]:.6g} -> "
              f"{rec['loss_curve'][-1][1]:.6g} (floor "
              f"{rec['mc_noise_floor_at_true_params']:.6g}); "
              f"{json.dumps({k: v for k, v in rec.items() if 'err' in k})}; "
              f"launches {json.dumps(launched)}; {rec['card']}")
    return out


# The bench_extra phase: every row's card-vs-plain check at BX_SIZE (W, H,
# spp, depth; 12 | W and H for the adaptive rows), and the kernels each
# row's call launches on the card (its route, ``bench_extra``'s
# ``kernels``; K3 and K3_record on either table route).
BX_SIZE = (72, 36, 2, 4)
BX_ROUTES = {
    "sphere_ground": {"K1"}, "random": {"K3"}, "textures": {"bounce"},
    "cornell": {"K1"}, "mesh": {"K5", "bounce"}, "final": {"K5", "bounce"},
    "mesh_hd": {"K5", "bounce"}, "mesh_grad": {"K5"},
    "sphere_ground_grad": {"K2", "replay"},
    "metal_diel_grad": {"K2", "replay"}, "mesh_grad_bench": {"K5"},
    "random_grad": {"K3_record", "replay"},
    "final_grad_bench": {"K5"}, "textures_grad": set(),
    "reference_default": {"K5", "bounce"}}
# (The forward rows through the wavefront evaluate their noise in the
# bounce kernel.  The gradient rows train tri_v* too, which
# ``render.noise_value_only`` takes as reaching the noise's argument, so
# their Perlin noise runs with its gradient in the point, on the autograd
# path and not through K4: no row launches K4.)
# The rows whose calls take a second or more run here at their full width
# with spp cut, one timed and one profiled call each, to keep the script
# within its time; ``python -m another_raytracer_tpu_torch.bench_extra``
# runs them whole.
BX_SPP_CUTS = {"textures": 4, "mesh": 4, "final": 2, "textures_grad": 4,
               "final_grad_bench": 2, "mesh_grad_bench": 4,
               "reference_default": 4}
BX_PROTOCOL = dict(reps=1, profiled_reps=1)
ROUTE_KERNELS = ("K1", "K2", "K3", "K3_record", "replay", "K5", "bounce")


def route(launched):
    """The kernels a launch-count dict shows, K3 and K3_record on either
    table route."""
    n = dict(launched)
    n["K3"] += n["K3_global"]
    n["K3_record"] += n["K3_record_global"]
    return {k for k in ROUTE_KERNELS if n[k]}


def bench_extra_phase(dev, tmp):
    """Every ``bench_extra`` row on the card, the capsule rows on
    ``write_capsule``'s mesh: (a) at BX_SIZE through the kernels against
    the same through their plain versions (forward rows to the bar of
    tests/test_mega.py:37-45, the adaptive row's image too; gradient rows:
    the loss to 1e-5 relative, each gradient to 1e-3 of its leaf's scale);
    (b) each row once at its full size through ``bench_extra.measure``
    (BX_SPP_CUTS' rows with spp cut and BX_PROTOCOL's reps), its record
    printed and its route held to BX_ROUTES, the counts set to 0 just
    before and read just after; (c) the scaling harness over ``[cuda:0] x
    4``, its 1-device and 4-shard renders bit-equal.  Returns {"rows": {row: record}, "launches":
    {kernel: {row: launches}}, "compare": {row: stats}, "scaling": ...}."""
    import torch

    from another_raytracer_tpu_torch import bench_extra, scaling_harness
    from another_raytracer_tpu_torch.ops.vec3 import V3
    from another_raytracer_tpu_torch.parallel import sharding

    obj = write_capsule(tmp)
    out = {"rows": {}, "launches": {k: {} for k in ROUTE_KERNELS},
           "compare": {}, "cuts": {}}
    bad = []

    def as_v3(img):
        flat = torch.from_numpy(img.reshape(-1, 3) / 255.0)
        return V3(*flat.unbind(1))

    for name, (_, *size, mode) in bench_extra.CONFIGS.items():
        try:
            wl = bench_extra.setup(name, dev, obj, BX_SIZE)
        except FileNotFoundError as e:
            phase("bench_extra", f"skip {name}: {e}")
            continue
        what = f"bench_extra {name} {wl.config}"
        call = bench_extra.CALLS[mode]
        got = call(wl)()
        reset_counts()
        with plain_versions(), plain_wavefront():
            ref = call(wl)()
        if route(counts()):
            raise AssertionError(f"{what}: the plain versions launched "
                                 f"{counts()}")
        if mode == "single":
            st = forward_bar(got[0], ref[0], got[1], ref[1], what)
        elif mode == "adaptive":
            st = forward_bar(as_v3(got[0]), as_v3(ref[0]),
                             got[1]["segments"], ref[1]["segments"], what)
            st["traced_pixels"] = got[1]["traced_pixels"]
            if got[1]["traced_pixels"] != ref[1]["traced_pixels"]:
                raise AssertionError(f"{what}: traced pixels {got[1]} vs "
                                     f"{ref[1]}")
        else:
            (loss, grads), (loss_p, grads_p) = got, ref
            st = {"loss": float(loss), "loss_rel": abs(
                float(loss) - float(loss_p)) / abs(float(loss_p)),
                  "grad_rel": max(leaf_rel(grads[k], grads_p[k])
                                  for k in grads)}
            if st["loss_rel"] > 1e-5 or st["grad_rel"] > 1e-3:
                raise AssertionError(f"{what}: card vs plain {st}")
        out["compare"][name] = st
        phase("bench_extra", f"{what}, card vs plain: {json.dumps(st)}")

        full, protocol = tuple(size), {}
        if name in BX_SPP_CUTS:
            full = (size[0], size[1], BX_SPP_CUTS[name], size[3])
            protocol = BX_PROTOCOL
            out["cuts"][name] = {"spp": full[2], "row_spp": size[2],
                                 **protocol}
            phase("bench_extra", f"{name}: spp cut from {size[2]} to "
                  f"{full[2]} here, {json.dumps(protocol)} (its full size "
                  "runs through python -m another_raytracer_tpu_torch."
                  "bench_extra)")
        wl = bench_extra.setup(name, dev, obj, full)
        reset_counts()
        rec, _ = bench_extra.measure(wl, **protocol)
        launched = counts()
        out["rows"][name] = rec
        for k in ROUTE_KERNELS:
            n = launched[k] + launched.get(k + "_global", 0)
            if n:
                out["launches"][k][name] = n
        phase("bench_extra", json.dumps(rec))
        if route(rec["kernels"]) != BX_ROUTES[name]:
            bad.append(f"{name}: launched {sorted(route(rec['kernels']))}, "
                       f"expected {sorted(BX_ROUTES[name])}")
    missing = [k for k, rows in out["launches"].items() if not rows]
    if bad or missing:
        raise AssertionError(f"bench_extra routes: {bad}; kernels never "
                             f"launched: {missing}")

    devices = ",".join([str(dev)] * 4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scaling_harness.main(["--devices", devices])
    lines = buf.getvalue().strip().splitlines()
    rates = [float(re.search(r"([\d.]+) Mrays/s", ln).group(1))
             for ln in lines if ln.startswith("devices=")]
    args = scaling_harness.parse_args(["--devices", devices])
    wl = bench_extra.setup("cornell", dev, size=(args.width, args.height,
                                                 args.spp, args.depth))
    one, four = (scaling_harness.render_fn(wl.scene, wl.cam, args, part)()
                 for part in (sharding.hybrid_partition(1, 1, devices=[dev]),
                              sharding.hybrid_partition(4, 1,
                                                        devices=[dev] * 4)))
    equal = (all(torch.equal(a, b) for a, b in zip(one[0], four[0]))
             and int(one[1]) == int(four[1]))
    out["scaling"] = {"lines": lines, "mrays_per_s": rates,
                      "bit_equal_1_vs_4": equal}
    phase("bench_extra", "scaling harness over [cuda:0] x 4: "
          + " | ".join(lines) + f"; 1-device and 4-shard renders bit-equal: "
          f"{equal}")
    if rc != 0 or len(rates) != 3 or not equal:
        raise AssertionError(f"scaling harness: {out['scaling']}")
    return out


def leaf_rel(got, want):
    """max |got - want| over want's scale (0 for an empty leaf)."""
    if not want.numel():
        return 0.0
    return (float((got - want).abs().max())
            / max(float(want.abs().max()), 1e-30))


def kernel_entries(log):
    """[(mangled kernel name, registers, spilled bytes)] of a -Xptxas -v
    build report."""
    names = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '?([\w$]+)", ln)
        if m:
            names.append(m.group(1))
    return [(nm,) + kernel_usage(log, nm) for nm in dict.fromkeys(names)]


def entry_phases(dev, cornell, cornell_cam, scene1, cam1):
    """The entry points over the kernels: the parallel modes, the adaptive
    mode over a partition, the progressive render, the CLI's sinks, JPEG,
    two processes, the sharded step, the two demos and the bench_extra
    rows with the scaling harness (each reads its own launch counts).
    Returns {phase: stats}."""
    with tempfile.TemporaryDirectory() as tmp:
        return {
            "modes": modes_phase(dev, cornell, cornell_cam, scene1, cam1, tmp),
            "adaptive_partition": adaptive_partition_phase(dev, cornell,
                                                           cornell_cam),
            "progressive": progressive_phase(dev, cornell, cornell_cam, tmp),
            "cli_entry": cli_entry_phase(dev, tmp),
            "jpeg": jpeg_phase(dev, tmp),
            "multihost": multihost_phase(dev, cornell, cornell_cam, tmp),
            "sharded_step": sharded_step_phase(dev, cornell, cornell_cam),
            "train_demo": train_demo_phase(dev),
            "bench_extra": bench_extra_phase(dev, tmp)}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
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
    from another_raytracer_tpu_torch.ops.vec3 import V3
    from another_raytracer_tpu_torch.utils import imageio, profiling

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build every target from the checkout's sources, in parallel, and
    # the host library (csrc/host) with the host compiler beside them.
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(host_library_phase)
        built = _build.build_all()
        host_line = host_build.result()
    for name, (path, secs) in built.items():
        usage = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", f"{path.name} in {secs:.1f} s: " + " | ".join(usage))
    phase("build", f"all targets in {time.perf_counter() - t0:.1f} s")
    # The template instances <walk> of each megakernel build: the sweep
    # (ILi0EE: K1, K2, the sweep's counting instance) and K3's walk on
    # tables in shared (ILi1EE) or device memory (ILi2EE).
    mega_builds = ("mega_kernel", "mega_kernel_record", "mega_kernel_count")
    regs = {(build, walk): kernel_usage(_build.build_log(build),
                                        f"mega_forward_kernelILi{tag}EE")
            for build in mega_builds for tag, walk in WALK_NAMES.items()}
    if any(spilled for _, spilled in regs.values()):
        raise AssertionError(f"an instance of the megakernel spills "
                             f"registers: {regs}")
    k1_regs, k2_regs = regs["mega_kernel", "sweep"][0], regs[
        "mega_kernel_record", "sweep"][0]
    k3_regs = {w: regs["mega_kernel", w][0] for w in ("shared", "global")}
    k3r_regs = {w: regs["mega_kernel_record", w][0]
                for w in ("shared", "global")}
    phase("build", "megakernel registers (spilled bytes) per build and "
          "instance: " + "; ".join(
              f"{build} {walk} {r} ({sp})" for (build, walk), (r, sp)
              in regs.items()))
    # The instruction census of each instance (static SASS counts).
    census = {build: sass_census(built[build][0]) for build in mega_builds}
    for build, per_walk in census.items():
        for walk, ops in per_walk.items():
            phase("census", f"{build} {walk}: {json.dumps(ops)}")
    for target in ("bvh_kernel", "perlin_kernel", "bounce_kernel"):
        entries = kernel_entries(_build.build_log(target))
        if not entries:
            raise AssertionError(f"no kernel in {target}'s build report")
        if target == "bounce_kernel" and any(sp for _, _, sp in entries):
            raise AssertionError(f"an instance of the bounce kernel spills "
                                 f"registers: {entries}")
        phase("build", f"{target}: " + "; ".join(
            f"{nm}: {regs} registers, {spill} bytes spilled"
            for nm, regs, spill in entries))

    # 2. Threefry words on the card: CUDA vs the port's torch threefry, and
    # the draws kernel (rng.uniform2 on CUDA tensors) vs its plain version.
    n = 1 << 20
    g = torch.Generator(device="cpu").manual_seed(0)
    pixel = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    sample = torch.randint(0, 2**32, (n,), generator=g, dtype=torch.int64).to(dev)
    bounces = torch.randint(0, 2**24, (n,), generator=g, dtype=torch.int64).to(dev)
    checked = 0
    for seed, bounce, dim in [(7, 0, 0), (0xDEADBEEF, 3, 2),
                              (12345, rng.CAMERA_BOUNCE, rng.DIM_TIME)]:
        key1 = (bounce << 8) | dim
        (w0, w1), (u0, u1) = mega_kernel.threefry_words_cuda(seed, key1, pixel, sample)
        r0, r1 = rng.threefry2x32(seed, key1, pixel, sample, rounds=rng.ROUNDS)
        v0, v1 = rng.uniform2_plain(seed, pixel, sample, bounce, dim)
        if not (torch.equal(w0, r0) and torch.equal(w1, r1)):
            raise AssertionError(f"threefry words differ (seed={seed}, key1={key1})")
        if not (torch.equal(u0.view(torch.int32), v0.view(torch.int32))
                and torch.equal(u1.view(torch.int32), v1.view(torch.int32))):
            raise AssertionError(f"uniform2 bits differ (seed={seed}, key1={key1})")
        for b in (bounce, bounces):
            for sd in (seed, torch.tensor(seed, device=dev)):
                got = rng.uniform2(sd, pixel, sample, b, dim)
                want = rng.uniform2_plain(sd, pixel, sample, b, dim)
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise AssertionError(f"the draws kernel differs from its "
                                         f"plain version (seed={seed}, "
                                         f"dim={dim})")
        checked += n
    phase("threefry", f"{checked} counters bit-exact (words and uniforms; "
          f"the draws kernel with int and [B] bounces, int and 0-d seeds)")

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
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--scene", "6", "--width", str(W), "--height", str(H),
                           "--spp", str(SPP), "--max-depth", str(DEPTH),
                           "--mode", "single", "--device", "cuda", "--out", out])
        k1_launches = counts()["K1"]
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
    # wrapper, median of 5 each; the plain version once.  K1 takes lanes by
    # lane fetch (a persistent grid); the per-block mapping (one lane per
    # thread) on the same inputs must give the same bits.
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cornell_cam)
    pix, samp = lanes(W, H, dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    run, (k1_out, k1_seg) = mega_kernel.prepare_launch(cornell, cam, pix, samp,
                                                       0, **kw)
    k1_ms, k1_runs = cuda_ms(bare(run), dev, 5)
    run, (pb_out, pb_seg) = mega_kernel.prepare_launch(
        cornell, cam, pix, samp, 0, lane_fetch=False, **kw)
    k1_pb_ms, k1_pb_runs = cuda_ms(bare(run), dev, 5)
    if not all(torch.equal(a, b) for a, b in zip((*k1_out, k1_seg),
                                                 (*pb_out, pb_seg))):
        raise AssertionError("K1 with lane fetch differs from the per-block "
                             "mapping")
    # The block size: K1 alone at each candidate.
    k1_block_ms = {}
    for blk in BLOCKS:
        run_b, _ = mega_kernel.prepare_launch(cornell, cam, pix, samp, 0,
                                              block=blk, **kw)
        k1_block_ms[blk] = cuda_ms(bare(run_b), dev, 3)[0]
    k1_wrap_ms, _ = cuda_ms(lambda: mega_kernel.trace_regenerative_mega(
        cornell, cam, pix, samp, 0, **kw), dev, 5)
    segs_k = int(k1_seg.sum())
    t = time.perf_counter()
    torch.cuda.synchronize(dev)
    _, segs_p = mega_kernel.trace_regenerative_mega_reference(
        cornell, cam, pix, samp, 0, **kw)
    torch.cuda.synchronize(dev)
    k1_plain_ms = (time.perf_counter() - t) * 1e3
    phase("timing_k1", f"cornell {W}x{H} spp{SPP} depth{DEPTH}: K1 alone "
          f"{k1_ms:.3f} ms (runs {k1_runs}; {100 * (k1_ms / K1_ROWS_MS - 1):+.1f}% "
          f"vs {K1_ROWS_MS} ms on the 32-float rows, "
          f"{100 * (k1_ms / K1_FIRST_MS - 1):+.1f}% vs {K1_FIRST_MS} ms as "
          f"first ported), lane fetch, block "
          f"{mega_kernel.K1_BLOCK}, {k1_regs} registers, no spills; one lane "
          f"per thread (block {mega_kernel.DEFAULT_BLOCK}) {k1_pb_ms:.3f} ms "
          f"(runs {k1_pb_runs}), outputs bit-equal; "
          f"by block {json.dumps(k1_block_ms)} ms; through its wrapper "
          f"{k1_wrap_ms:.3f} ms; {segs_k} segments, "
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
        # Built without FMA contraction, K2 is its plain version bit for bit.
        if not (st["bit_equal"] and st["segments"] == st["segments_plain"]):
            raise AssertionError(f"K2 differs from its plain version on {name}")

    # 7. The replay vs its plain version on K2's own residuals.
    replay_stats, replay_args = compare_replay(cornell, rec["cornell"][1], dev)
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
    reset_counts()
    losses = []
    t = time.perf_counter()
    for k in range(TRAIN_STEPS):
        state, loss = step(state, 1000 + k)
        losses.append(float(loss))
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t
    k2_launches, replay_launches = counts()["K2"], counts()["replay"]
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
    phase("timing_kernels", f"cornell {BW}x{BH} spp{BSPP} depth{BDEPTH}: K2 "
          f"alone {k2_ms:.3f} ms ({100 * (k2_ms / K2_ROWS_MS - 1):+.1f}% vs "
          f"{K2_ROWS_MS} ms on the 32-float rows) vs plain {k2_plain_ms:.1f} "
          f"ms ({k2_regs} registers)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rp4 = replay_timings(replay_args, dev, sms)
    phase("timing_replay", f"cornell {BW}x{BH} spp{BSPP} depth{BDEPTH}, "
          f"T = 4: {json.dumps(rp4)}")
    # The fused step reads the record where K2 wrote it: one step with the
    # record's buffer and the replay's inputs looked at as they pass.
    seen = {}
    with spy(mega_kernel, "prepare_launch",
             lambda out: out[1][-1].dim() == 3
             and seen.setdefault("record", out[1][-1])), \
            spy(mega_diff, "replay_inputs",
                lambda out: seen.setdefault("inputs", out)):
        diff.render_value_and_grad(
            params, cornell, bcam, torch.zeros((BW * BH, 3), device=dev), 0,
            width=BW, height=BH, spp=BSPP, samples_per_pass=1,
            max_depth=BDEPTH, t_min=1e-3)
    reads_record(seen["inputs"], V3(*seen["record"].unbind(0)))
    phase("timing_replay", "the fused step's replay read tprev in K2's "
          f"buffer ({seen['record'].data_ptr():#x}, no copy)")

    # Inside the sweep (its counting instance: the record build's arithmetic,
    # the same lanes): K1's launch at the README size with lane fetch and
    # with the per-block mapping, and K2's at the bench size, whose row tests,
    # segments and radiance must equal the plain version's.
    sweep_tal = {
        "K1": mega_kernel.sweep_tallies(cornell, cam, *lanes(W, H, dev), 0,
                                        **kw)[2],
        "K1 per-block mapping": mega_kernel.sweep_tallies(
            cornell, cam, *lanes(W, H, dev), 0, lane_fetch=False, **kw)[2]}
    fkw = {k: v for k, v in bkw.items() if k != "record_iters"}
    rad_c, segs_c, sweep_tal["K2"] = mega_kernel.sweep_tallies(
        cornell, bcam, pix, samp, 0, lane_fetch=False, **fkw)
    ref_c = mega_kernel.trace_regenerative_mega_reference(
        cornell, bcam, pix, samp, 0, work=True, **fkw)
    tal_k2 = sweep_tal["K2"]
    if ((tal_k2["sphere_tests"], tal_k2["rect_tests"]) != tuple(ref_c[-1])
            or int(segs_c) != int(ref_c[1])
            or not all(torch.equal(a, b) for a, b in zip(rad_c, ref_c[0]))):
        raise AssertionError(f"the sweep's counting instance differs from the "
                             f"plain version: {tal_k2} vs {ref_c[-1]}")
    for name, t in sweep_tal.items():
        warps = t["blocks"] * -(-t["block"] // 32)
        phase("sweep_tallies", f"{name}: {t['sphere_tests']} sphere and "
              f"{t['rect_tests']} rect row tests "
              f"({t['rows_per_segment']:.2f} rows per segment); loop "
              f"active-lane share {t['loop_simt']:.4f}; warp loop steps "
              f"mean {t['loop_steps'] / warps:.1f}, max "
              f"{t['warp_loop_steps_max']}; tail share {t['tail_share']:.4f} "
              f"over {t['slots']} slots, {t['blocks']} blocks of "
              f"{t['block']}, "
              f"{t['launch_ms']:.3f} ms on the device clock")
    phase("sweep_tallies", f"K2's row tests ({tal_k2['sphere_tests']}, "
          f"{tal_k2['rect_tests']}), segments and radiance equal the plain "
          f"version's")

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
    for case in cases + [k5_sheet_case(dev)]:
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
        st.update(K5_launches=launched["K5"], K4_launches=launched["K4"],
                  draws_launches=launched["draws"],
                  bounce_launches=launched["bounce"])
        if (sc.has_accel and launched["K5"] < 1) or launched["K4"] or (
                launched["draws"] < 1) or launched["bounce"] < 1:
            raise AssertionError(f"{name}: the wavefront skipped a kernel {st}")
        phase("compare_wavefront", f"{name} {CW}x{CH} spp{CSPP} depth{DEPTH}: "
              f"{json.dumps(st)}")

    # 13. The wavefront's BVH path: scene 1 through the CLI at the README
    # size with MEGA_FORWARD = False (its auto route is K3, section 17): the
    # forward gate's measurement of the wavefront + K5.
    with tempfile.TemporaryDirectory() as tmp, mega_forward(False):
        rc, out, img, launched = run_cli(1, W, H, SPP, DEPTH, tmp)
    bvh_wall_ms, bvh_mrays, bvh_segs = cli_stats(out)
    k5_launches, draws_launches = launched["K5"], launched["draws"]
    if (rc != 0 or k5_launches < 1 or launched["K1"]
            or bvh_segs != WAVEFRONT_SEGMENTS[1]):
        raise AssertionError(f"main path (scene 1): rc={rc} {launched}, "
                             f"{bvh_segs} segments\n{out}")
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
    k5_trace = [(ms, c) for nm, ms, c in top if "bvh_kernel" in nm]
    k5_trace_ms = sum(ms for ms, _ in k5_trace)
    phase("profile_bvh", f"scene 1 {W}x{H} spp1 depth{DEPTH}: {wall_ms:.1f} ms "
          f"wall, {iters} loop iterations ({wall_ms / iters:.2f} ms each); "
          f"traced: device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% "
          f"of the bare wall), {n_kern} device ops "
          f"({n_kern / iters:.0f} per iteration); K5 {k5_trace_ms:.3f} ms over "
          f"{sum(c for _, c in k5_trace)} launches "
          f"({100 * k5_trace_ms / busy_ms:.1f}% of the device time); top by "
          f"device time: "
          + "; ".join(f"{nm} {ms:.1f} ms / {c}" for nm, ms, c in top[:8]))

    # 14. The texture main path: scenes 3, 4 and 5 through the CLI.
    tex_segments = {}
    for sid in (3, 4, 5):
        with tempfile.TemporaryDirectory() as tmp:
            rc, out, img, launched = run_cli(sid, W, H, TEX_SPP, DEPTH, tmp)
        wall_ms, mrays, segs = cli_stats(out)
        if rc != 0 or segs <= 0 or launched["K4"] or launched["bounce"] < 1 or (
                segs != WAVEFRONT_SEGMENTS.get(sid, segs)):
            raise AssertionError(f"main path (scene {sid}): rc={rc} {launched}, "
                                 f"{segs} segments")
        if img.shape != (H, W, 3) or img.mean() < 2.0:
            raise AssertionError(f"scene {sid} image is wrong: {img.mean()}")
        tex_segments[sid] = segs
        phase("main_path_textures", f"scene {sid} {W}x{H} spp{TEX_SPP} "
              f"depth{DEPTH} (CLI): {wall_ms} ms wall, {segs} segments, "
              f"{mrays} Mrays/s; launches {json.dumps(launched)}; PNG mean "
              f"{img.mean():.2f}")

    # 15. K5 alone at the main path's widths and K4 at a frame's points,
    # beside their plain versions and their bounds.  ``graph_ms`` gives the device time of a
    # launch without the host's submission; ``cuda_ms``'s events around one
    # bare launch, which include it, are printed beside it.  K5: the first
    # call of the scene-1 render, its camera rays (388,800 lanes) against
    # the sphere tree with the sphere fold (the render's first stage is
    # above its gate), then the three comparison cases, each with the
    # wavefront's variant: the counting build's tallies (the walk's slab and
    # leaf row tests, equal to the plain version's counts, active-lane
    # shares and tail share), the bound from the plain version's counts, and
    # the time at each block size.
    from another_raytracer_tpu_torch.ops import intersect

    n = W * H
    if intersect.fold_tree(scene1, n) != "sphere":
        raise AssertionError("the timed K5 call is below the fold's gate")
    first = k5_first_call(dev, scene1, cam1)
    args, kw = k5_args(first, dev)
    k5_times = {}
    for label, fold in (("fold", True), ("no fold", False)):
        k5_times[label] = graph_ms(lambda: bvh_kernel.prepare_launch(
            *args, t_min=1e-3, fold_record=fold, tables=scene1.k5_tables(
                "sphere"), **kw)[0], dev, 20)[0]
    k5_ms = k5_times["fold"]
    k5_event_ms = cuda_ms(bare(bvh_kernel.prepare_launch(
        *args, t_min=1e-3, fold_record=True, **kw)[0]), dev, 10)[0]
    tm = kw.pop("time")
    k5_plain_ms, _ = cuda_ms(lambda: bvh_ops.traverse_packed(
        *args[:4], tm, 1e-3, *args[4:], fold_record=True, **kw), dev, 1)
    k5_cases_ms = {}
    for case in [first] + cases:
        prim = case[7]
        fold, full, pre = k5_main(prim, scene1 if prim == "sphere" else None)
        work = k5_work(case, fold, full, pre, dev)
        _, slabs, tests, hits, b_ms, b_by = work
        tl = k5_tallies(case, fold, full, pre, dev, work=work)
        cargs, ckw = k5_args(case, dev)
        row = {}
        for p in ((pre, False) if prim == "planar" else (pre,)):
            tables = bvh_kernel.pack_tables(cargs[0], cargs[1], prim, p)
            row["ms" if p == pre else "ms_no_precomp"] = graph_ms(
                lambda: bvh_kernel.prepare_launch(
                    *cargs, t_min=1e-3, fold_record=fold, fold_full=full,
                    precomp=p, tables=tables, **ckw)[0], dev, 20)[0]
        row.update(route=bvh_kernel.table_route(bvh_kernel.pack_tables(
            cargs[0], cargs[1], prim, pre)), rays=cargs[2].x.shape[0],
            slab_tests=slabs, leaf_tests=tests, hits=hits, bound_ms=b_ms,
            bound_by=b_by, share_of_bound=b_ms / row["ms"],
            tallies={k: tl[k] for k in ("slab_simt", "leaf_simt", "tail_share",
                                        "blocks", "launch_ms")},
            block_ms=k5_shapes(case, fold, full, pre, dev))
        k5_cases_ms[case[0]] = row
        phase("timing_k4_k5", f"K5 on {case[0]} ({prim}, fold={int(fold)} "
              f"full={int(full)} precomp={int(pre)}, block "
              f"{bvh_kernel.BLOCK}): {json.dumps(row)}")
    k5_bound_ms = k5_cases_ms[first[0]]["bound_ms"]
    k5_bound_by = k5_cases_ms[first[0]]["bound_by"]
    phase("timing_k4_k5", f"K5, scene 1's first call ({n} camera rays, sphere "
          f"tree of {scene1.n_spheres} spheres, leaf {scene1.bvh_leaf_size}): "
          f"{json.dumps({k: round(v, 5) for k, v in k5_times.items()})} ms "
          f"(events around one launch: {k5_event_ms:.4f} ms); plain "
          f"{k5_plain_ms:.1f} ms; bound {k5_bound_ms:.4f} ms by {k5_bound_by}; "
          f"{k5_launches} launches per scene-1 render")

    scene3, _ = library.two_perlin_spheres(device=dev)
    g = np.random.default_rng(2)
    pv = V3(*(torch.from_numpy(g.uniform(-20, 20, n).astype(np.float32)).to(dev)
              for _ in range(3)))
    ids = torch.zeros(n, dtype=torch.int64, device=dev)
    k4_ms, k4_runs = graph_ms(
        lambda: perlin_kernel.prepare_launch(scene3, ids, pv)[0], dev)
    k4_event_ms = cuda_ms(bare(perlin_kernel.prepare_launch(scene3, ids, pv)[0]),
                          dev, 10)[0]
    # The branch for one table set and no id array against the plain
    # version, bit for bit.
    run, got = perlin_kernel.prepare_launch(scene3, ids, pv)
    bare(run)()
    want = shade.perlin_noise(scene3, ids, pv)
    torch.cuda.synchronize(dev)
    k4_err = max(k4_err, float((got - want).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError(f"K4 (one table set, {n} points) disagrees with "
                             f"its plain version: {k4_err}")
    phase("compare_k4", f"one table set (no id array) at {n} points: "
          f"bit-equal")
    # One block's worth of points: the launch and the stage of the tables.
    p1 = V3(*(c[:256] for c in pv))
    k4_floor_ms = graph_ms(lambda: perlin_kernel.prepare_launch(
        scene3, ids[:256], p1)[0], dev)[0]
    k4_plain_ms, _ = cuda_ms(lambda: shade.perlin_noise(scene3, ids, pv), dev, 3)

    def k4_bound(m):
        # Each point's three coordinates in and its value out, and the one
        # table set.
        return bound(m * OPS_PERLIN,
                     m * (3 * 4 + 4) + perlin_kernel.TABLE_BYTES)

    k4_bound_ms, k4_bound_by = k4_bound(n)
    phase("timing_k4_k5", f"K4, {n} points of scene 3's table set: {k4_ms:.5f} "
          f"ms (runs {k4_runs}; events around one launch: {k4_event_ms:.4f} "
          f"ms); at 256 points (one block: the launch and the stage) "
          f"{k4_floor_ms:.5f} ms; plain {k4_plain_ms:.3f} ms; bound "
          f"{k4_bound_ms:.5f} ms by {k4_bound_by}")

    # The draws kernel (rng.uniform2 on CUDA tensors) at the wavefront's
    # first and narrowest stage widths, with a [B] bounce (the scatter and
    # media draws: three int64 in) and an int one (the camera's: two), on a
    # 0-d seed tensor as the stages' graphs hold it; beside its bound and
    # its plain version's device time, both by ``graph_ms``.
    draws = threefry_draws_timings(dev)
    phase("timing_draws", f"draws kernel: {json.dumps(draws)}; "
          f"{draws_launches} launches per scene-1 render")

    # 16. Media and meshes: scenes 7 and 8, and scene 9 through --obj on a
    # 5,760-triangle capsule that this script writes.  Their forward renders
    # take the wavefront (the megakernel refuses media and triangles): K5
    # on scene 8's rect and sphere trees (tables in shared memory) and on
    # the mesh's planar tree (device memory), K4 on scene 8's marble
    # sphere; scene 7 has no tree and no noise.  Gradients take the
    # lockstep autograd path.
    mesh_dir = tempfile.mkdtemp()
    try:
        media = media_phases(dev, mesh_dir)
    finally:
        import shutil

        shutil.rmtree(mesh_dir, ignore_errors=True)

    # 17. The megakernel's accel mode (K3).  Its forward instance against
    # its plain version on scene 1 and the 81-sphere tree.
    k3_cmp = {}
    for name, (sc, cp), counter in [
            ("scene 1 (random)", (scene1, cam1), "K3"),
            ("81-sphere tree", bvh_sphere_scene(dev), "K3"),
            ("dense 6,000-sphere grid (device-memory walk)",
             dense_spheres_scene(dev), "K3_global")]:
        reset_counts()
        st = compare(sc, cp, CW, CH, CSPP, DEPTH, dev, what=f"K3 on {name}")
        if counts()[counter] != 1:
            raise AssertionError(f"{name}: the comparison skipped K3 {counts()}")
        k3_cmp[name] = st
        phase("compare_k3", f"{name} {CW}x{CH} spp{CSPP} depth{DEPTH}: "
              f"{json.dumps(st)}")

    # Its record instance and the replay at scene 1's 485 textures (the
    # block-wide table) at the bench size.
    # Bit-equal through both walks: scene 1's tables in shared memory, and
    # a synthetic 6,000-sphere tree's in device memory.
    reset_counts()
    st_k3r, got_k3r, bcam1 = compare_record(scene1, cam1, dev, what="K3 record")
    phase("compare_k3_record", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH} "
          f"(shared-memory walk): {json.dumps(st_k3r)}")
    many, many_cam = many_spheres_scene(dev)
    st_k3rg, _, _ = compare_record(many, many_cam, dev,
                                   what="K3 record (device-memory walk)")
    walked = counts()
    phase("compare_k3_record", f"{many.n_spheres} spheres "
          f"({mega_kernel.accel_smem_bytes(many)} B of tables) {BW}x{BH} "
          f"spp{BSPP} depth{BDEPTH} (device-memory walk): "
          f"{json.dumps(st_k3rg)}; launches {json.dumps(walked)}")
    if not (st_k3r["bit_equal"] and st_k3rg["bit_equal"]):
        raise AssertionError("K3's record instance differs from its plain "
                             "version")
    if (walked["K3_record"], walked["K3_record_global"]) != (1, 1):
        raise AssertionError(f"the record comparisons skipped a walk {walked}")
    rp485, rp485_args = compare_replay(scene1, got_k3r, dev)
    phase("compare_replay", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}: "
          f"{json.dumps(rp485)}")

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
    # K3 and the wavefront both re-project sphere hits onto their spheres:
    # the README render through K3 traces within 1% of the wavefront's
    # segments (section 13's pinned count).
    k3_segs, wave_segs = accel_cli["single"][2], WAVEFRONT_SEGMENTS[1]
    if abs(k3_segs - wave_segs) > 0.01 * wave_segs:
        raise AssertionError(f"scene 1: K3 traces {k3_segs} segments, the "
                             f"wavefront {wave_segs}")
    phase("main_path_accel", f"scene 1 segments: K3 {k3_segs}, the "
          f"wavefront {wave_segs} ({k3_segs / wave_segs - 1:+.4%})")
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
    # it) and through its wrapper.
    cam = camera_lib.make_camera(aspect_ratio=W / H, device=dev, **cam1)
    order, _ = render_lib.morton_order(W, H)
    pix_m = torch.from_numpy(order.astype(np.int64)).to(dev)
    samp_m = torch.zeros_like(pix_m)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
              max_depth=DEPTH, t_min=1e-3)
    run, (_, k3_seg) = mega_kernel.prepare_launch(scene1, cam, pix_m, samp_m,
                                                  0, **kw)
    k3_ms, k3_runs = cuda_ms(bare(run), dev, 5)
    # The block size: K3 alone at each candidate (DEFAULT_BLOCK's evidence).
    k3_block_ms = {}
    for blk in BLOCKS:
        run_b, _ = mega_kernel.prepare_launch(scene1, cam, pix_m, samp_m, 0,
                                              block=blk, **kw)
        k3_block_ms[blk] = cuda_ms(bare(run_b), dev, 3)[0]
    k3_wrap_ms, _ = cuda_ms(lambda: mega_kernel.trace_regenerative_mega(
        scene1, cam, pix_m, samp_m, 0, **kw), dev, 3)
    segs_k3 = int(k3_seg.sum())
    # Its plain version at the README width and K3_PLAIN_SPP samples (at 100
    # it takes minutes: one host step per node of the walk).  Over 388,800
    # lanes a lane nearly always holds a path that FMA contraction flipped,
    # so the per-lane bar (made for a few samples, compare_k3) does not
    # apply: hold the segments and the image's mean radiance to 1%.
    kw4 = dict(kw, sample_end=K3_PLAIN_SPP, spp_cap=K3_PLAIN_SPP)
    got4, segs4 = mega_kernel.trace_regenerative_mega(scene1, cam, pix_m,
                                                      samp_m, 0, **kw4)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    ref4, ref_segs4 = mega_kernel.trace_regenerative_mega_reference(
        scene1, cam, pix_m, samp_m, 0, **kw4)
    torch.cuda.synchronize(dev)
    k3_plain_ms = (time.perf_counter() - t) * 1e3
    got_mean = float(torch.stack(tuple(got4)).mean())
    plain_mean = float(torch.stack(tuple(ref4)).mean())
    st_full = dict(spp=K3_PLAIN_SPP, segments=int(segs4),
                   segments_plain=int(ref_segs4), mean_radiance=got_mean,
                   mean_radiance_plain=plain_mean)
    if (abs(int(segs4) - int(ref_segs4)) > 0.01 * int(ref_segs4)
            or abs(got_mean - plain_mean) > 0.01 * plain_mean):
        raise AssertionError(f"K3 at the README width disagrees with its "
                             f"plain version: {st_full}")
    # The walk's work on this run's inputs, from the counting instance (its
    # totals equal the plain version's: checked at the bench size below).
    _, _, tal = mega_kernel.walk_tallies(scene1, cam, pix_m, samp_m, 0, **kw)
    slabs3, tests3 = tal["slab_tests"], tal["sphere_tests"]
    nodes_bytes = scene1.sph_bvh_nodes.numel() * 4
    rows_bytes = scene1.sph_bvh_rows.shape[0] * mega_kernel.ROW_W * 4
    k3_bound_ms, k3_bound_by = bound(
        slabs3 * bvh_ops.OPS_PER_SLAB
        + tests3 * bvh_ops.OPS_PER_TEST["sphere", False]
        + segs_k3 * (OPS_SEGMENT + OPS_K3_WINNER),
        W * H * 24 + rows_bytes + nodes_bytes)
    simt = {m: round(tal[m], 4) for m in ("slab_simt", "leaf_simt",
                                          "ground_share")}
    phase("timing_k3", f"scene 1 {W}x{H} spp{SPP} depth{DEPTH}: K3 alone "
          f"{k3_ms:.3f} ms (runs {k3_runs}), block "
          f"{mega_kernel.DEFAULT_BLOCK}, {k3_regs['shared']} registers, "
          f"{mega_kernel.accel_smem_bytes(scene1)} B of shared memory, no "
          f"spills; through its wrapper {k3_wrap_ms:.3f} ms; {segs_k3} "
          f"segments, {segs_k3 / k3_ms / 1e3:.1f} Mrays/s; plain at spp"
          f"{K3_PLAIN_SPP} {k3_plain_ms:.1f} ms ({json.dumps(st_full)}); "
          f"{slabs3} slab and {tests3} sphere tests ({slabs3 / segs_k3:.1f} / "
          f"{tests3 / segs_k3:.1f} per segment): bound {k3_bound_ms:.3f} ms by "
          f"{k3_bound_by}; active-lane shares {json.dumps(simt)}; by block "
          f"{json.dumps(k3_block_ms)} ms")

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
    k3r_block_ms = {}
    for blk in BLOCKS:
        run_b, _ = mega_kernel.prepare_launch(scene1, bcam1, pixb, sampb, 0,
                                              block=blk, **rkw)
        k3r_block_ms[blk] = cuda_ms(bare(run_b), dev, 3)[0]
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    ref_k3r = mega_kernel.trace_regenerative_mega_reference(
        scene1, bcam1, pixb, sampb, 0, work=True, **rkw)
    torch.cuda.synchronize(dev)
    k3r_plain_ms = (time.perf_counter() - t) * 1e3
    slabs3r, tests3r = ref_k3r[-1]
    # The counting instance on the same lanes walks exactly the plain
    # version's nodes and rows.
    fkw = {k: v for k, v in rkw.items() if k != "record_iters"}
    rad_c, segs_c, tal_b = mega_kernel.walk_tallies(scene1, bcam1, pixb,
                                                    sampb, 0, **fkw)
    work_c = (tal_b["slab_tests"], tal_b["sphere_tests"])
    if (work_c != (slabs3r, tests3r) or int(segs_c) != int(ref_k3r[1])
            or not all(torch.equal(a, b) for a, b in zip(rad_c, ref_k3r[0]))):
        raise AssertionError(f"the counting instance differs from the plain "
                             f"version: {work_c} vs {(slabs3r, tests3r)}")
    simt_b = {m: round(tal_b[m], 4) for m in ("slab_simt", "leaf_simt",
                                              "ground_share")}
    phase("compare_k3_count", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}: "
          f"the counting instance's {slabs3r} slab and {tests3r} sphere tests, "
          f"segments and radiance equal the plain version's; active-lane "
          f"shares {json.dumps(simt_b)}")
    resid = BSPP * BDEPTH * BW * BH * 16
    k3r_bound_ms, k3r_bound_by = bound(
        slabs3r * bvh_ops.OPS_PER_SLAB
        + tests3r * bvh_ops.OPS_PER_TEST["sphere", False]
        + st_k3r["segments"] * (OPS_SEGMENT + OPS_K3_WINNER),
        BW * BH * 24 + rows_bytes + nodes_bytes + resid)
    rp485_t = replay_timings(rp485_args, dev, sms)
    phase("timing_k3", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}: K3 record "
          f"alone {k3r_ms:.3f} ms vs plain {k3r_plain_ms:.1f} ms "
          f"({k3r_regs['shared']} registers), bound {k3r_bound_ms:.4f} ms by "
          f"{k3r_bound_by}; by block {json.dumps(k3r_block_ms)} ms")
    phase("timing_replay", f"scene 1 {BW}x{BH} spp{BSPP} depth{BDEPTH}, T = "
          f"{rp485['textures']}: {json.dumps(rp485_t)}")

    entry = entry_phases(dev, cornell, cornell_cam, scene1, cam1)
    modes, jpeg, sharded_step, demos = (entry["modes"], entry["jpeg"],
                                        entry["sharded_step"],
                                        entry["train_demo"])
    bx = entry["bench_extra"]["launches"]

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

    smi = profiling.card_line()
    phase("total", f"chip_smoke ran {time.perf_counter() - _T0:.1f} s, builds "
          "included")
    print("host library: " + json.dumps({**host_line, "jpeg": {
        k: jpeg[k] for k in ("baseline_420", "progressive", "chroma_420",
                             "chroma_progressive", "mesh")}}))
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "mega_kernel forward instance (K1, forward sweep megakernel)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:224",
         "launches": k1_launches,
         "max_abs_err": results["cornell"]["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound_ms, "bound_by": k1_bound_by, "library_ms": None,
         "wrapper_ms": k1_wrap_ms, "registers": k1_regs,
         "lane_fetch": True, "per_block_mapping_ms": k1_pb_ms,
         "block": mega_kernel.K1_BLOCK, "block_ms": k1_block_ms,
         "loop_simt": sweep_tal["K1"]["loop_simt"],
         "tail_share": sweep_tal["K1"]["tail_share"],
         "tail_share_per_block_mapping":
             sweep_tal["K1 per-block mapping"]["tail_share"],
         "segments": segs_k, "mrays_per_s": segs_k / k1_ms / 1e3,
         "bench_extra_launches": bx["K1"],
         "partitions": {k: v for k, v in modes.items() if k != "scene1 4x1"},
         **{k: entry[k] for k in ("adaptive_partition", "progressive",
                                  "cli_entry", "multihost")}},
        {"name": "mega_kernel record instance (K2, fused differentiable primal)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:691",
         "launches": k2_launches,
         "max_abs_err": st_c["max_abs_err"],
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_ms, "bound_by": k2_bound_by, "library_ms": None,
         "registers": k2_regs,
         "loop_simt": tal_k2["loop_simt"], "tail_share": tal_k2["tail_share"],
         "lanes_codes_equal": st_c["lanes_codes_equal"],
         "bit_equal": st_c["bit_equal"],
         "bench_extra_launches": bx["K2"],
         "sharded_step": sharded_step,
         "train_demo": {
             "launches": demos["cornell"]["launches"]["K2"],
             **{k: demos["cornell"]["record"][k] for k in (
                 "steps", "ms_per_step", "loss_curve", "tex_ca_mean_abs_err",
                 "mc_noise_floor_at_true_params")}}},
        {"name": "mega_kernel accel forward instance (K3, megakernel with "
                 "the sphere-BVH walk)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:882",
         "launches": k3_launches,
         "max_abs_err": k3_cmp["scene 1 (random)"]["max_abs_err"],
         "ms": k3_ms, "plain_ms": k3_plain_ms, "plain_spp": K3_PLAIN_SPP,
         "bound_ms": k3_bound_ms, "bound_by": k3_bound_by, "library_ms": None,
         "wrapper_ms": k3_wrap_ms, "registers": k3_regs["shared"],
         "registers_device_memory_walk": k3_regs["global"],
         "block": mega_kernel.DEFAULT_BLOCK,
         "smem_bytes": mega_kernel.accel_smem_bytes(scene1),
         "block_ms": k3_block_ms,
         "slab_simt": tal["slab_simt"], "leaf_simt": tal["leaf_simt"],
         "ground_share": tal["ground_share"],
         "segments": segs_k3, "mrays_per_s": segs_k3 / k3_ms / 1e3,
         "bench_extra_launches": bx["K3"],
         "stripes_4x1": modes["scene1 4x1"]},
        {"name": "mega_kernel accel record instance (K3, fused "
                 "differentiable primal on a sphere tree)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": JAX_PALLAS + "mega_kernel.py:882",
         "launches": train_launched["K3_record"],
         "max_abs_err": st_k3r["max_abs_err"],
         "ms": k3r_ms, "plain_ms": k3r_plain_ms,
         "bound_ms": k3r_bound_ms, "bound_by": k3r_bound_by,
         "library_ms": None, "registers": k3r_regs["shared"],
         "registers_device_memory_walk": k3r_regs["global"],
         "block": mega_kernel.DEFAULT_BLOCK,
         "smem_bytes": mega_kernel.accel_smem_bytes(scene1),
         "block_ms": k3r_block_ms,
         "slab_simt": tal_b["slab_simt"], "leaf_simt": tal_b["leaf_simt"],
         "lanes_codes_equal": st_k3r["lanes_codes_equal"],
         "bit_equal": st_k3r["bit_equal"],
         "bit_equal_device_memory_walk": st_k3rg["bit_equal"],
         "bench_extra_launches": bx["K3_record"]},
        {"name": "mega_replay (replay backward of the fused path)",
         "route": "cuda", "source": SRC + "mega_replay.cu",
         "replaces": JAX_PALLAS + "mega_diff.py:266",
         "launches": replay_launches,
         "max_abs_err": replay_stats["max_abs_err"],
         "library_ms": None, **rp4,
         "bit_deterministic": replay_stats["bit_deterministic"],
         "sharded_step_launches": {k: sharded_step[k]["replay"]
                                   for k in ("4x1", "7x1")},
         "train_demo_launches": demos["cornell"]["launches"]["replay"],
         "bench_extra_launches": bx["replay"],
         "large_t": {"launches": train_launched["replay"],
                     "max_abs_err": rp485["max_abs_err"],
                     "library_ms": None, **rp485_t,
                     "bit_deterministic": rp485["bit_deterministic"]}},
        {"name": "bvh_kernel (K5, BVH closest hit)",
         "route": "cuda", "source": SRC + "bvh_kernel.cu",
         "replaces": JAX_PALLAS + "bvh_kernel.py:537",
         "launches": k5_launches,
         "max_abs_err": max(st["max_abs_err_t"] for st in
                            k5_stats + list(
                                media["scene8_first_call"].values())),
         "ms": k5_ms, "plain_ms": k5_plain_ms,
         "bound_ms": k5_bound_ms, "bound_by": k5_bound_by, "library_ms": None,
         "event_ms": k5_event_ms, "variant_ms": k5_times,
         "block": bvh_kernel.BLOCK,
         "cases": k5_cases_ms, "trace_ms_scene1_spp1": k5_trace_ms,
         "comparison": k5_verdict,
         "media_and_meshes": {
             "launches_per_render": {k: v["K5_by_tree"]
                                     for k, v in media["renders"].items()},
             "bit_equal_wavefront": {k: v["bit_equal"]
                                     for k, v in media["compare"].items()},
             "scene8_first_call": media["scene8_first_call"],
             "mesh_first_call": media["mesh_first_call"],
             "device_share_spp1": {k: v["K5_share"]
                                   for k, v in media["profiles"].items()}},
         "scene8_jpeg_earthmap": jpeg["scene8"],
         "bench_extra_launches": bx["K5"]},
        {"name": "perlin_kernel (K4, Perlin noise)",
         "route": "cuda", "source": SRC + "perlin_kernel.cu",
         "replaces": JAX_PALLAS + "perlin_kernel.py:136",
         "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain_ms,
         "bound_ms": k4_bound_ms, "bound_by": k4_bound_by, "library_ms": None,
         "event_ms": k4_event_ms, "points": n, "one_block_ms": k4_floor_ms,
         "segments": tex_segments,
         "launches_scene8": media["renders"]["scene 8 single"]["K4"],
         "launches_scene8_jpeg_earthmap": jpeg["scene8"]["launches"]["K4"]},
        {"name": "uniform2_draws_kernel (rng.uniform2 on CUDA tensors)",
         "route": "cuda", "source": SRC + "mega_kernel.cu",
         "replaces": None,  # XLA fuses the JAX package's int64 draws
         "launches": draws_launches, "max_abs_err": 0.0,
         "timings": draws, "library_ms": None,
         "launches_per_render": {k: v["draws"]
                                 for k, v in media["renders"].items()}},
        {"name": "bounce_kernel (the wavefront's step after K5)",
         "route": "cuda", "source": SRC + "bounce_kernel.cu",
         "replaces": None,  # XLA fuses the JAX package's step
         "max_abs_err": max(r["max_abs_err"]
                            for r in media["bounce"].values()),
         "timings": media["bounce"],
         "launches_per_render": {k: v["bounce"]
                                 for k, v in media["renders"].items()},
         "device_share_spp1": {k: v["bounce_share"]
                               for k, v in media["profiles"].items()},
         "bench_extra_launches": bx["bounce"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
