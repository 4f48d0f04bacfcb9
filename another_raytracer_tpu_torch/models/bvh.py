"""Host-side BVH construction over primitive bounds (a copy of
``another_raytracer_tpu.models.bvh``, numpy only).

The reference builds a binary BVH of shared_ptr nodes with a *random* split
axis and median sort (bvh.cpp:3-42).  Deliberate divergence, as in the JAX
package (PARITY.md #6): the split axis is the widest centroid extent, with
the same median split.  The tree is emitted as flat arrays in depth-first
order with *escape indices* for stackless traversal on the device
(``ops/bvh.py``, ``ops/kernels/bvh_kernel.py``): a node either advances to
``i+1`` (box hit) or jumps to ``escape[i]`` (box missed / subtree done);
leaves reference a contiguous run of reordered primitive ids.

The build must stay identical to the JAX package's (tests hold the two
trees equal array for array), since the traversal order decides ties.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

LEAF_SIZE = 8


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray  # [M,3]
    node_max: np.ndarray  # [M,3]
    escape: np.ndarray  # [M] int32: next node index when this box is missed
    leaf_first: np.ndarray  # [M] int32: first index into prim_order (leaves)
    leaf_count: np.ndarray  # [M] int32: 0 for internal nodes
    prim_order: np.ndarray  # [N] int32: primitive ids in leaf-contiguous order

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def build(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build from per-primitive AABBs ([N,3] mins/maxs, float64)."""
    n = mins.shape[0]
    assert n > 0
    centroids = 0.5 * (mins + maxs)

    nodes_min, nodes_max, escape, leaf_first, leaf_count = [], [], [], [], []
    prim_order = []

    def emit(ids) -> int:
        """Emit subtree for primitive ids; returns node index."""
        idx = len(nodes_min)
        lo = mins[ids].min(axis=0)
        hi = maxs[ids].max(axis=0)
        nodes_min.append(lo)
        nodes_max.append(hi)
        escape.append(-1)  # patched after subtree emission
        if len(ids) <= leaf_size:
            leaf_first.append(len(prim_order))
            leaf_count.append(len(ids))
            prim_order.extend(ids.tolist())
        else:
            leaf_first.append(0)
            leaf_count.append(0)
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = np.argsort(c[:, axis], kind="stable")
            # Median split rounded to a leaf_size multiple: every leaf except
            # possibly the last comes out full.
            half = max(leaf_size, (len(ids) // 2 // leaf_size) * leaf_size)
            emit(ids[order[:half]])
            emit(ids[order[half:]])
        escape[idx] = len(nodes_min)  # one past the subtree in DFS order
        return idx

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.ceil(np.log2(max(n, 2)))) + 10000))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        node_min=np.asarray(nodes_min),
        node_max=np.asarray(nodes_max),
        escape=np.asarray(escape, np.int32),
        leaf_first=np.asarray(leaf_first, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        prim_order=np.asarray(prim_order, np.int32),
    )


# Flat-primitive AABB padding.  The slab test is strict (tn < tf), so a
# zero-extent axis (an axis-aligned rect/triangle) would make its own box
# unhittable; the reference pads rect boxes the same way (aarect.h k±0.0001).
FLAT_PAD = 1e-4


def pad_flat(mins, maxs):
    thin = (maxs - mins) < FLAT_PAD
    return np.where(thin, mins - FLAT_PAD, mins), np.where(thin, maxs + FLAT_PAD, maxs)


def triangle_bounds(v0, v1, v2):
    """Per-triangle AABBs (triangle.h:90-95), padded on flat axes."""
    mins = np.minimum(np.minimum(v0, v1), v2)
    maxs = np.maximum(np.maximum(v0, v1), v2)
    return pad_flat(mins, maxs)


def rect_bounds(axis, k, lo, hi):
    """Per-axis-rect AABBs (aarect.h:16-21 semantics: flat on `axis` at k,
    spanning lo/hi on the two free axes in ascending order), padded flat."""
    axis = np.asarray(axis, np.int64)
    n = axis.shape[0]
    mins = np.zeros((n, 3))
    maxs = np.zeros((n, 3))
    au = np.where(axis == 0, 1, 0)
    av = np.where(axis == 2, 1, 2)
    rng = np.arange(n)
    mins[rng, axis] = maxs[rng, axis] = np.asarray(k, np.float64)
    mins[rng, au] = np.asarray(lo, np.float64)[:, 0]
    mins[rng, av] = np.asarray(lo, np.float64)[:, 1]
    maxs[rng, au] = np.asarray(hi, np.float64)[:, 0]
    maxs[rng, av] = np.asarray(hi, np.float64)[:, 1]
    return pad_flat(mins, maxs)


def sphere_bounds(c0, c1, r, t0=None, t1=None, exposure=(0.0, 1.0)):
    """Per-sphere AABBs over the camera exposure window.

    The sphere tests lerp the center with an UNCLAMPED time fraction
    (moving_sphere.h:29-31 divides, never clamps), so a ray time outside the
    sphere's own [t0, t1] lands on the extrapolated segment.  Centers are
    extrapolated to both exposure endpoints (main.cpp:35 shutter [0,1])
    before taking the hull, as the reference boxes moving spheres at the
    camera's times (moving_sphere.h:60-74).  |r| handles the reference's
    negative-radius hollow dielectrics."""
    c0 = np.asarray(c0, np.float64)
    c1 = np.asarray(c1, np.float64)
    if t0 is not None:
        t0 = np.asarray(t0, np.float64)[:, None]
        t1 = np.asarray(t1, np.float64)[:, None]
        dt = np.where(t1 != t0, t1 - t0, 1.0)
        ca = c0 + (exposure[0] - t0) / dt * (c1 - c0)
        cb = c0 + (exposure[1] - t0) / dt * (c1 - c0)
        c0, c1 = ca, cb
    r = np.abs(np.asarray(r, np.float64))[:, None]
    mins = np.minimum(c0, c1) - r
    maxs = np.maximum(c0, c1) + r
    return mins, maxs
