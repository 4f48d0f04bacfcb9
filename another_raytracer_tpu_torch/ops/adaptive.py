"""Adaptive hierarchical subsampling, the reference's default render mode
(port of ``another_raytracer_tpu.ops.adaptive``, one device).

Behavioural port of ``engine::_run_adaptive`` (engine.h:96-333): the image is
tiled into 12x12 "big squares"; the 4 corner pixels of each square are path
traced at full spp into a gamma-corrected int work frame; if all 4 edge
distances (sum of squared RGB deltas) are <= 100 the interior is bilinearly
interpolated *in gamma-int space* (the reference's documented darkening
bias, engine.h:139-149); otherwise the square recurses to 6x6 then 3x3, and
at 3x3 the 5 non-corner pixels are traced exactly.  Raises unless 12 | W and
12 | H (engine.h:181-183).

The scalar tree walk runs level by level: each level's pixels go to the
device as one batch through ``render.radiance_batch`` (so scene 1 runs the
megakernel's accel mode K3 and the Cornell box its sweep mode K1), the host
reads back the level's colours, decides which squares subdivide and fills
the flat ones.  The JAX package pads each batch to a multiple of 8192 lanes
(dead lanes, ``lane_mask``) and packs the level's outputs into one array:
the first so that XLA compiles a handful of shapes, the second because a
device-to-host read cost ~0.3 s on its TPU host.  Neither holds here:
PyTorch runs eagerly and the kernels take any lane count (a block's ragged
edge is masked in the kernel), and a read from the card costs microseconds.
So a batch is exactly the level's pixels, unpadded, and is read back as is.
On a BVH scene the batch is sorted into Morton order first, so that a
warp's lanes are neighbouring pixels whose walks of the tree coincide (as
``render.render_radiance`` orders a full image).

The multi-device branch (the JAX ``mesh`` argument) is ROADMAP M18.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.ops import render as render_lib

SUBDIVIDE_THRESH = 100  # engine.h:98


def _to_int_color(radiance_sum, spp):
    """write_color<int>: mean, gamma-2, clamp [0,0.999], x256, truncate
    (color.h:13-22)."""
    c = np.sqrt(np.maximum(radiance_sum / spp, 0.0))
    return (256.0 * np.clip(c, 0.0, 0.999)).astype(np.int64)


def _heuristic(work, xs, ys, size, thresh=SUBDIVIDE_THRESH):
    """Corner-difference subdivision test (engine.h:96-137) for squares with
    upper-left pixels (xs, ys), vectorised; returns a bool array."""
    s = size - 1
    c1 = work[ys, xs].astype(np.int64)  # up-left
    c2 = work[ys, xs + s].astype(np.int64)  # up-right
    c3 = work[ys + s, xs].astype(np.int64)  # bottom-left
    c4 = work[ys + s, xs + s].astype(np.int64)  # bottom-right
    d1 = ((c1 - c2) ** 2).sum(-1)
    d2 = ((c2 - c4) ** 2).sum(-1)
    d3 = ((c4 - c3) ** 2).sum(-1)
    d4 = ((c3 - c1) ** 2).sum(-1)
    return (d1 > thresh) | (d2 > thresh) | (d3 > thresh) | (d4 > thresh)


def _interpolate_squares(work, xs, ys, size):
    """Bilinear fill of each square's un-evaluated pixels from its corner
    colours, in gamma-int space with truncation (engine.h:139-149,186-219)."""
    if len(xs) == 0:
        return
    s = size - 1
    q11 = work[ys, xs].astype(np.float64)  # (x1, y1)
    q12 = work[ys + s, xs].astype(np.float64)  # (x1, y2)
    q21 = work[ys, xs + s].astype(np.float64)  # (x2, y1)
    q22 = work[ys + s, xs + s].astype(np.float64)  # (x2, y2)
    for l in range(size):  # noqa: E741
        wy = l / s
        for k in range(size):
            if (k, l) in ((0, 0), (s, 0), (0, s), (s, s)):
                continue
            wx = k / s
            r1 = (1 - wx) * q11 + wx * q21
            r2 = (1 - wx) * q12 + wx * q22
            val = ((1 - wy) * r1 + wy * r2).astype(np.int64)
            px = xs + k
            py = ys + l
            not_eval = work[py, px, 0] < 0  # don't overwrite evaluated pixels
            work[py[not_eval], px[not_eval]] = val[not_eval]


def _corners(xs, ys, size):
    """Flat x and y of the 4 corners of each square (upper-left xs, ys)."""
    offs = np.array([0, size - 1])
    cx, cy = np.broadcast_arrays(xs[:, None, None] + offs[None, :, None],
                                 ys[:, None, None] + offs[None, None, :])
    return cx.ravel(), cy.ravel()


def _quarters(xs, ys, half):
    """Upper-left corners of the 4 sub-squares of each square."""
    return ((xs[:, None] + np.array([0, half, 0, half])[None, :]).ravel(),
            (ys[:, None] + np.array([0, 0, half, half])[None, :]).ravel())


def render_adaptive(scene, cam, config: RenderConfig, mesh=None):
    """Adaptive render -> (uint8 image [H, W, 3] on the host, stats).

    ``stats['traced_pixels']`` counts the pixels actually path traced (the
    honest workload measure the reference's kRay/s metric overcounts) and
    ``stats['segments']`` the traced ray segments, bounces included.  The
    scene and camera decide the device.
    """
    if mesh is not None:
        raise NotImplementedError(
            "adaptive mode over a device mesh is not ported yet (ROADMAP "
            "M18); render on one device")
    W, H = config.width, config.height
    big = config.adaptive_tile
    if big % 2 != 0 or (big // 2) % 2 != 0:
        raise ValueError("adaptive tile must be divisible by 4 (12 canonical)")
    mid, small = big // 2, big // 4
    if W % big or H % big:
        raise ValueError(
            "for adaptive strategy image size should perfectly fit big square "
            "size for now!!")

    spp = config.samples_per_pixel
    spass = (config.samples_per_pass if config.adaptive_spass is None
             else config.adaptive_spass)
    dev = scene.device
    work = np.full((H, W, 3), -1, np.int64)
    total_segments = 0
    traced = 0
    morton_rank = (render_lib.morton_order(W, H)[1] if scene.has_accel
                   else None)

    def eval_pixels(px, py):
        """Trace the unique, not yet evaluated pixels at full spp into the
        work frame.  The reference re-traces corners shared between levels
        (engine.h:222-232); with a per-(pixel, sample) RNG a re-trace gives
        the same value, so skipping it changes only the work done."""
        nonlocal total_segments, traced
        if len(px) == 0:
            return
        flat = np.unique(py.astype(np.int64) * W + px.astype(np.int64))
        flat = flat[work[flat // W, flat % W, 0] < 0]
        if len(flat) == 0:
            return
        if morton_rank is not None:
            flat = flat[np.argsort(morton_rank[flat], kind="stable")]
        traced += len(flat)
        acc, segments = render_lib.radiance_batch(
            scene, cam, torch.from_numpy(flat).to(dev), config.seed,
            width=W, height=H, sample_start=0, n_samples=spp, spp_cap=spp,
            samples_per_pass=spass, max_depth=config.max_depth,
            t_min=config.t_min)
        total_segments += int(segments)
        # float32, as the JAX package converts it.
        rad = torch.stack(tuple(acc), dim=1).cpu().numpy()
        work[flat // W, flat % W] = _to_int_color(rad, spp)

    level = [0]

    def show_progress():
        # Console progress line per level (the reference's "\r...%" lines,
        # engine.h:320); the filled fraction counts decided pixels.
        level[0] += 1
        decided = int((work[..., 0] >= 0).sum())
        print(f"\radaptive level {level[0]}: {decided * 100 // (W * H)}% "
              f"filled, {traced} traced", end="", file=sys.stderr, flush=True)

    thresh = config.adaptive_threshold
    # Level 0: big-square corners.
    bx, by = np.meshgrid(np.arange(0, W, big), np.arange(0, H, big))
    bx, by = bx.ravel(), by.ravel()
    eval_pixels(*_corners(bx, by, big))
    sub_big = _heuristic(work, bx, by, big, thresh)
    _interpolate_squares(work, bx[~sub_big], by[~sub_big], big)
    show_progress()

    # Level 1: mid-square corners inside the subdivided big squares.
    sx, sy = _quarters(bx[sub_big], by[sub_big], mid)
    eval_pixels(*_corners(sx, sy, mid))
    sub_mid = (_heuristic(work, sx, sy, mid, thresh) if len(sx)
               else np.zeros(0, bool))
    _interpolate_squares(work, sx[~sub_mid], sy[~sub_mid], mid)
    show_progress()

    # Level 2: small-square corners inside the subdivided mid squares.
    tx, ty = _quarters(sx[sub_mid], sy[sub_mid], small)
    eval_pixels(*_corners(tx, ty, small))
    sub_small = (_heuristic(work, tx, ty, small, thresh) if len(tx)
                 else np.zeros(0, bool))
    _interpolate_squares(work, tx[~sub_small], ty[~sub_small], small)
    show_progress()

    # Level 3: exact trace of the remaining pixels of subdivided small
    # squares (for small = 3 the 5 non-corner pixels, engine.h:265-277).
    ex, ey = [], []
    for k in range(small):
        for l in range(small):  # noqa: E741
            if (k, l) in ((0, 0), (small - 1, 0), (0, small - 1),
                          (small - 1, small - 1)):
                continue
            ex.append(tx[sub_small] + k)
            ey.append(ty[sub_small] + l)
    if ex:
        eval_pixels(np.concatenate(ex), np.concatenate(ey))

    assert (work >= 0).all(), "adaptive fill left unevaluated pixels"
    print(f"\radaptive done: 100% filled, {traced}/{W * H} pixels traced",
          file=sys.stderr, flush=True)
    return work.astype(np.uint8), {
        "segments": total_segments,
        "traced_pixels": traced,
        "total_pixels": W * H,
        "mesh": None,
    }
