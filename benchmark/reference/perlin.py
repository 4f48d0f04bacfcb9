"""Perlin noise (*The Next Week*'s ``perlin.h``): gradient noise on a
lattice hashed by three permutations of 256, trilinear over the cell's
eight corners with Hermite-smoothed weights.

The tables are scene data made from the configuration's ``scene_seed``, as
weights are for a model: a NumPy ``default_rng(scene_seed)`` draws, for
each noise texture in the order the configuration lists them, 256 gradients
``uniform(-1, 1, (256, 3))`` made unit, then three ``permutation(256)``.
(The book draws its gradients with ``random_double`` and shuffles with its
own ``permute``; the draws here are the configuration's recipe.)"""

from __future__ import annotations

import numpy as np
import torch

POINTS = 256


def tables(seed: int, count: int):
    """(gradients [count, 256, 3] float64, permutations [count, 3, 256]
    int64) of ``count`` noise textures drawn from ``seed``."""
    gen = np.random.default_rng(seed)
    ranvec, perm = [], []
    for _ in range(count):
        g = gen.uniform(-1.0, 1.0, size=(POINTS, 3))
        ranvec.append(g / np.linalg.norm(g, axis=-1, keepdims=True))
        perm.append(np.stack([gen.permutation(POINTS) for _ in range(3)]))
    if not count:
        return np.zeros((0, POINTS, 3)), np.zeros((0, 3, POINTS), np.int64)
    return np.stack(ranvec), np.stack(perm).astype(np.int64)


def noise(ranvec, perm, which, p):
    """The noise [B] of table ``which`` [B] (int64) at points ``p`` [B, 3]:
    perlin.h ``noise`` and ``perlin_interp``."""
    f = torch.floor(p)
    uvw = p - f
    ijk = f.long()
    smooth = uvw * uvw * (3.0 - 2.0 * uvw)
    out = torch.zeros_like(p[:, 0])
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                corner = torch.tensor((di, dj, dk), device=p.device)
                hashed = ((ijk + corner) & (POINTS - 1))  # [B, 3]
                h = (perm[which, 0, hashed[:, 0]]
                     ^ perm[which, 1, hashed[:, 1]]
                     ^ perm[which, 2, hashed[:, 2]])
                grad = ranvec[which, h]  # [B, 3]
                weight = torch.where(corner.bool(), smooth, 1.0 - smooth)
                out = out + weight.prod(1) * (grad * (uvw - corner)).sum(1)
    return out
