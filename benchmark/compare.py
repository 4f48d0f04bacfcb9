"""The numbers that decide ``correct``: what the program produced against
what the plain reference (``benchmark/reference``) works out from the same
inputs, each held to a limit of its own from the cell's workload file."""

from __future__ import annotations

import numpy as np
import torch

TILE = 12  # the side of a square of ``tile_gap``


def image(prog: np.ndarray, ref: np.ndarray) -> dict:
    """``image_mad``: the mean absolute difference of the two uint8 images
    over every channel of every pixel, in levels; ``tile_gap``: the widest
    difference of the two images' means over a 12 x 12 square, in levels
    (a fault confined to a few pixels shows there)."""
    d = prog.astype(np.int64) - ref.astype(np.int64)
    h, w, _ = d.shape
    tiles = d.reshape(h // TILE, TILE, w // TILE, TILE, 3).mean(axis=(1, 3, 4))
    return {"image_mad": float(np.abs(d).mean()),
            "tile_gap": float(np.abs(tiles).max())}


def rel_gap(prog: float, ref: float) -> float:
    return abs(float(prog) - float(ref)) / abs(float(ref))


def _norms(leaves: dict) -> dict:
    return {k: float(torch.as_tensor(v).double().norm()) for k, v in
            leaves.items()}


def leaf_gap(prog: dict, ref: dict, only=None) -> float:
    """The worst leaf's gap between the norms of the program's and the
    reference's leaves, over the larger of the reference leaf's norm and
    the median of the reference's nonzero leaf norms.  ``only`` limits the
    leaves compared."""
    pn, rn = _norms(prog), _norms(ref)
    keys = [k for k in rn if only is None or k in only]
    median = float(np.median([rn[k] for k in keys if rn[k] > 0]))
    return max(abs(pn[k] - rn[k]) / max(rn[k], median) for k in keys)


def moved_leaves(first_grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient norm reaches ``share`` of the
    median nonzero leaf's: those that adam moves by more than round-off."""
    n = _norms(first_grads)
    median = float(np.median([v for v in n.values() if v > 0]))
    return [k for k, v in n.items() if v >= share * median]


def verdict(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] of every number, in the order of ``limits``;
    a number passes when it is at most its limit."""
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]
