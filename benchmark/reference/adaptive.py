"""The adaptive mode (the reference's ``engine::_run_adaptive``): the image
is cut into 12 x 12 squares; the corners of a square are traced at full
spp into an integer gamma frame; a square whose four edges all differ by
at most ``threshold`` (the sum of squared RGB differences of the two
corners) is filled bilinearly in that integer space and truncated, else it
splits into four 6 x 6 squares, those into 3 x 3 ones, and a 3 x 3 square
that splits has its five other pixels traced.  A pixel is traced once."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import tracer

THRESHOLD = 100


def render(sc, cam, *, width, height, spp, max_depth, seed, tile=12,
           t_min=1e-3):
    """(uint8 image [H, W, 3] numpy, segments, traced pixels)."""
    if width % tile or height % tile:
        raise ValueError("the adaptive mode needs 12 | width and height")
    frame = np.full((height, width, 3), -1, np.int64)
    done = {"segments": 0, "traced": 0}

    def trace(xs, ys):
        flat = np.unique(np.asarray(ys, np.int64) * width
                         + np.asarray(xs, np.int64))
        flat = flat[frame.reshape(-1, 3)[flat, 0] < 0]
        if flat.size == 0:
            return
        pixels = torch.as_tensor(flat, device=sc.device)
        with torch.no_grad():
            acc, segments = tracer.radiance(
                sc, cam, pixels, width=width, height=height, spp=spp,
                max_depth=max_depth, seed=seed, t_min=t_min)
        done["segments"] += segments
        done["traced"] += flat.size
        value = (256.0 * tracer.gamma(acc, spp)).long().cpu().numpy()
        frame.reshape(-1, 3)[flat] = value

    def corners(x, y, size):
        s = size - 1
        return ([x, x + s, x, x + s], [y, y, y + s, y + s])

    squares = [(x, y) for y in range(0, height, tile)
               for x in range(0, width, tile)]
    size = tile
    while squares:
        cx, cy = [], []
        for x, y in squares:
            xs, ys = corners(x, y, size)
            cx += xs
            cy += ys
        trace(cx, cy)
        split = []
        for x, y in squares:
            s = size - 1
            c = [frame[y, x], frame[y, x + s], frame[y + s, x],
                 frame[y + s, x + s]]  # up-left, up-right, down-left, -right
            edges = ((c[0], c[1]), (c[1], c[3]), (c[3], c[2]), (c[2], c[0]))
            if any(int(((a - b) ** 2).sum()) > THRESHOLD for a, b in edges):
                split.append((x, y))
                continue
            w = np.arange(size)[:, None] / s  # [size, 1]
            top = (1 - w.T[..., None]) * c[0] + w.T[..., None] * c[1]
            bottom = (1 - w.T[..., None]) * c[2] + w.T[..., None] * c[3]
            fill = ((1 - w[..., None]) * top + w[..., None] * bottom)
            block = frame[y:y + size, x:x + size]
            empty = block[..., 0] < 0
            block[empty] = fill.astype(np.int64)[empty]
        if size == tile // 4:
            xs, ys = [], []
            for x, y in split:
                for l in range(size):  # noqa: E741
                    for k in range(size):
                        xs.append(x + k)
                        ys.append(y + l)
            trace(xs, ys)
            break
        half = size // 2
        squares = [(x + dx, y + dy) for x, y in split
                   for dy in (0, half) for dx in (0, half)]
        size = half
    return frame.astype(np.uint8), done["segments"], done["traced"]
