"""Stackless BVH traversal as tensor ops: the plain PyTorch version of the
BVH closest-hit kernel K5 (port of ``another_raytracer_tpu.ops.bvh``).

Every ray carries its own node cursor over the flat escape-index layout
(``models/bvh.py``, packed by ``ops/kernels/bvh_kernel.py``): a slab test
against node ``j``'s box within ``[t_min, best_t]``; on a hit the ray moves
to ``j + 1`` (and a leaf's primitives are tested in leaf order with the
strict ``t < best_t`` rule), on a miss it jumps to the escape index.  One
loop iteration advances every ray that is still inside the tree by one node;
finished rays drop out of the working set.

The primitive tests are the CUDA kernel's (``csrc/bvh_kernel.cu``) operation
for operation, and so the Pallas kernel's (``bvh_kernel.py:224-529`` there):
the triangle test uses the triple-product edge form, the sphere test the
half-b quadratic with the precomputed 1/a, the rect test the sweep's plane
solve with inclusive bounds; the folds (``fold_record``, ``fold_full``,
``precomp``) are computed with the kernel's own formulas, so this function
computes the same function as the kernel, bit for bit where each operation
rounds the same way (the kernel is built without FMA contraction).

A leaf's tests run as one ``[L, leaf_size]`` batch: each candidate's t is
tested against the lane's best on entry to the leaf, and the first minimum
wins.  That is the sequential strict-``<`` fold's result: a candidate that
is valid against the running best is valid against the entry best, a
candidate that the running best rejects is no smaller than it, and a tie
keeps the earlier primitive either way (a sphere's root choice against the
running best picks the far root only where the near one is no better than
the running best, and the far root is larger still).

``counts=True`` also returns, per ray, the slab tests and the primitive
tests it ran: the work K5 does on these inputs, which ``chip_smoke.py``
turns into the kernel's bound.
"""

from __future__ import annotations

import torch

from another_raytracer_tpu_torch.ops import vec3
from another_raytracer_tpu_torch.ops.vec3 import V3

BIG = 3e37
META_SCALE = 64  # leaf_meta = first * META_SCALE + count (bvh_kernel.py)

# Floating-point operations per test in csrc/bvh_kernel.cu, counted from
# its source (adds, multiplies, divides, square roots, min / max and
# compares; selects and integer work not counted): the input of the
# kernel's bound.  A slab test is 6 subtracts, 6 multiplies, 12 min / max
# and one compare.
OPS_PER_SLAB = 25
OPS_PER_TEST = {
    # ndotd, ndoto (10), t (sub, div, compare), p (6), three edge values
    # (18), the compares (6); the cross products and dots of the
    # non-precomputed form add 3 crosses (27), 6 subtracts and 4 dots (20).
    ("planar", False): 96,
    ("planar", True): 43,
    # frac, center, oc (10), half_b (5), c (7), disc (3), sqrt, roots (6),
    # the compares (6).
    ("sphere", False): 39,
    ("rect", False): 15,
}
# Extra operations of a fold per valid candidate (normal, barycentrics,
# texcoords; the sphere's centre at the ray's time: frac, 3 products and 3
# sums).
OPS_PER_FOLD = {("planar", False): 8, ("planar", True): 17,
                ("sphere", False): 8}


def safe_inv(c):
    """1 / c with |c| floored at 1e-20 (signed), as the kernels take it."""
    tiny = torch.where(c < 0, torch.full_like(c, -1e-20),
                       torch.full_like(c, 1e-20))
    return 1.0 / torch.where(c.abs() < 1e-20, tiny, c)


def _planar_test(r, o, d, best_t, t_min, fold_record, fold_full, precomp):
    """Leaf triangles: r [L, K, C] rows, o / d V3 of [L, 1]."""
    if precomp:
        n = V3(r[..., 17], r[..., 18], r[..., 19])
        ndotv0 = r[..., 20]
        m0 = V3(r[..., 21], r[..., 22], r[..., 23])
        m1 = V3(r[..., 24], r[..., 25], r[..., 26])
        m2 = V3(r[..., 27], r[..., 28], r[..., 29])
        c0, c1, c2 = r[..., 30], r[..., 31], r[..., 32]
    else:
        v0 = V3(r[..., 0], r[..., 1], r[..., 2])
        v1 = V3(r[..., 3], r[..., 4], r[..., 5])
        v2 = V3(r[..., 6], r[..., 7], r[..., 8])
        n = vec3.cross(v1 - v0, v2 - v0)
        ndotv0 = vec3.dot(n, v0)
        m0 = vec3.cross(n, v1 - v0)
        m1 = vec3.cross(n, v2 - v1)
        m2 = vec3.cross(n, v0 - v2)
        c0, c1, c2 = vec3.dot(m0, v0), vec3.dot(m1, v1), vec3.dot(m2, v2)
    ndotd = vec3.dot(n, d)
    ndoto = vec3.dot(n, o)
    ok = ndotd != 0.0
    t = torch.where(ok, (ndotv0 - ndoto)
                    / torch.where(ok, ndotd, torch.ones_like(ndotd)),
                    torch.full_like(ndotd, BIG))
    p = o + d * t
    w0 = vec3.dot(p, m0) - c0
    w1 = vec3.dot(p, m1) - c1
    w2 = vec3.dot(p, m2) - c2
    valid = (ok & (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & (t > t_min)
             & (t < best_t))
    if not fold_record:
        return t, valid, ()
    # u weights vertex 1 (edge m1), v weights vertex 2 (edge m2): the
    # record's dot(n, cross(e, p - a)) / |n|^2 by the triple-product identity.
    if precomp:
        inv_n2, inv_len = r[..., 33], r[..., 34]
    else:
        n2 = torch.clamp_min(vec3.dot(n, n), 1e-37)
        inv_n2 = 1.0 / n2
        inv_len = 1.0 / vec3.sqrt(n2)
    uu = w1 * inv_n2
    vv = w2 * inv_n2
    aux = (n.x * inv_len, n.y * inv_len, n.z * inv_len, uu, vv)
    if fold_full:
        uv0u, uv0v, uv1u, uv1v = r[..., 10], r[..., 11], r[..., 12], r[..., 13]
        uv2u, uv2v, mat = r[..., 14], r[..., 15], r[..., 16]
        tu = uv2u + uu * (uv0u - uv2u) + vv * (uv1u - uv2u)
        tv = uv2v + uu * (uv0v - uv2v) + vv * (uv1v - uv2v)
        aux = aux + (tu, tv, mat)
    return t, valid, aux


def _sphere_test(r, o, d, time, a_vec, inv_a, best_t, t_min, fold_record):
    frac = (time - r[..., 6]) * r[..., 7]
    ocx = o.x - (r[..., 0] + frac * r[..., 3])
    ocy = o.y - (r[..., 1] + frac * r[..., 4])
    ocz = o.z - (r[..., 2] + frac * r[..., 5])
    rad = r[..., 8]
    half_b = ocx * d.x + ocy * d.y + ocz * d.z
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = half_b * half_b - a_vec * c
    ok = disc > 0.0
    sq = vec3.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    root1 = (-half_b - sq) * inv_a
    root2 = (-half_b + sq) * inv_a
    r1_ok = (root1 > t_min) & (root1 < best_t)
    t = torch.where(r1_ok, root1, root2)
    valid = ok & (t > t_min) & (t < best_t)
    if not fold_record:
        return t, valid, ()
    # The world centre at the ray's time and the radius, from which the
    # record re-projects the hit point (ops/intersect.py).
    aux = (r[..., 0] + frac * r[..., 3], r[..., 1] + frac * r[..., 4],
           r[..., 2] + frac * r[..., 5], rad, r[..., 10], r[..., 11])
    return t, valid, aux


def _rect_test(r, o, d, best_t, t_min):
    ax, kk = r[..., 0], r[..., 1]
    is0, is2 = ax == 0.0, ax == 2.0
    o_ax = torch.where(is0, o.x, torch.where(is2, o.z, o.y))
    d_ax = torch.where(is0, d.x, torch.where(is2, d.z, d.y))
    parallel = d_ax == 0.0
    t = torch.where(parallel, torch.full_like(d_ax, BIG),
                    (kk - o_ax) / torch.where(parallel, torch.ones_like(d_ax),
                                              d_ax))
    pu = torch.where(is0, o.y, o.x) + t * torch.where(is0, d.y, d.x)
    pv = torch.where(is2, o.y, o.z) + t * torch.where(is2, d.y, d.z)
    inside = ((pu >= r[..., 2]) & (pu <= r[..., 4]) & (pv >= r[..., 3])
              & (pv <= r[..., 5]))
    valid = inside & (t > t_min) & (t < best_t) & ~parallel
    return t, valid, ()


def n_aux(prim: str, fold_record: bool, fold_full: bool) -> int:
    """Fold outputs per ray: planar (n, u, v[, tu, tv, mat]), sphere
    (centre, r, mat, has_uv)."""
    if not fold_record:
        return 0
    if prim == "sphere":
        return 6
    return 8 if fold_full else 5


def check_variant(rows, prim, fold_record, fold_full, precomp):
    """Raise on a (prim, fold, rows) combination the kernels do not take."""
    if prim not in ("planar", "sphere", "rect"):
        raise ValueError(f"unknown prim {prim!r}")
    if fold_record and prim == "rect":
        raise ValueError("fold_record takes prim 'planar' or 'sphere'")
    if fold_full and (prim != "planar" or not fold_record):
        raise ValueError("fold_full needs prim 'planar' and fold_record")
    if fold_full and rows.shape[1] < 17:
        raise ValueError("fold_full needs rows with uv / mat columns")
    if precomp and (prim != "planar" or rows.shape[1] < 35):
        raise ValueError("precomp needs 35-column planar rows")


def traverse_packed(nodes, rows, o: V3, d: V3, time, t_min, init_t, init_idx,
                    *, leaf_size: int, prim: str = "planar",
                    fold_record: bool = False, fold_full: bool = False,
                    precomp: bool = False, counts: bool = False):
    """Closest hit over a packed BVH, one stackless walk per ray.

    Args and returns as the wrapper ``ops.kernels.bvh_kernel.bvh_closest_hit``
    (whose plain version this is): (t [B], code [B] int32 — row column 9 where
    improved, else ``init_idx`` —, improved [B] bool), then with
    ``fold_record`` the winner's fold outputs (zeros where not improved):
    planar (unit normal V3, u, v[, tu, tv, mat]), sphere (centre at the
    ray's time V3, radius, mat, has_uv).  With ``counts`` also (slab tests [B], primitive tests [B])
    as int64.  ``time`` may be None (zeros).
    """
    check_variant(rows, prim, fold_record, fold_full, precomp)
    B = o.x.shape[0]
    dev = o.x.device
    t_min = float(t_min)
    n_nodes, n_rows = nodes.shape[0], rows.shape[0]
    lo, hi = nodes[:, 0:3], nodes[:, 3:6]
    esc = nodes[:, 6].long()
    meta = nodes[:, 7].long()
    leaf_count = meta % META_SCALE
    leaf_first = meta // META_SCALE
    if time is None:
        time = torch.zeros_like(o.x)
    inv = V3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z))

    best_t = init_t.clone()
    best_i = init_idx.to(torch.int32).clone()
    improved = torch.zeros(B, dtype=torch.bool, device=dev)
    n_out = n_aux(prim, fold_record, fold_full)
    aux = torch.zeros((n_out, B), dtype=torch.float32, device=dev)
    slabs = torch.zeros(B, dtype=torch.int64, device=dev)
    tests = torch.zeros(B, dtype=torch.int64, device=dev)
    cursor = torch.zeros(B, dtype=torch.int64, device=dev)
    ks = torch.arange(leaf_size, device=dev)

    lanes = torch.arange(B, device=dev)
    if n_nodes == 0:
        lanes = lanes[:0]
    while lanes.numel():
        j = cursor[lanes]
        bt = best_t[lanes]
        o_l = V3(o.x[lanes], o.y[lanes], o.z[lanes])
        inv_l = V3(inv.x[lanes], inv.y[lanes], inv.z[lanes])
        tn = torch.full_like(bt, t_min)
        tf = bt
        for c in range(3):
            a = (lo[j, c] - o_l[c]) * inv_l[c]
            b = (hi[j, c] - o_l[c]) * inv_l[c]
            tn = torch.maximum(tn, torch.minimum(a, b))
            tf = torch.minimum(tf, torch.maximum(a, b))
        hit_box = tn < tf
        slabs[lanes] += 1

        cnt = leaf_count[j]
        at_leaf = hit_box & (cnt > 0)
        if bool(at_leaf.any()):
            ll = lanes[at_leaf]
            jl = j[at_leaf]
            take = ks[None, :] < torch.clamp_max(cnt[at_leaf], leaf_size)[:, None]
            rid = torch.clamp_max(leaf_first[jl][:, None] + ks[None, :],
                                  n_rows - 1)
            r = rows[rid]  # [L, K, C]
            col = lambda v: v[ll][:, None]  # noqa: E731
            o1, d1 = V3(*map(col, o)), V3(*map(col, d))
            bt1 = best_t[ll][:, None]
            if prim == "planar":
                t, valid, fold = _planar_test(r, o1, d1, bt1, t_min,
                                              fold_record, fold_full, precomp)
            elif prim == "sphere":
                a_vec = vec3.dot(d1, d1)
                inv_a = 1.0 / torch.where(a_vec > 0.0, a_vec,
                                          torch.ones_like(a_vec))
                t, valid, fold = _sphere_test(r, o1, d1, col(time), a_vec,
                                              inv_a, bt1, t_min, fold_record)
            else:
                t, valid, fold = _rect_test(r, o1, d1, bt1, t_min)
            valid = valid & take
            tests[ll] += take.sum(dim=1)
            tm, k = torch.min(torch.where(valid, t, torch.full_like(t, float("inf"))),
                              dim=1)
            win = valid.any(dim=1)
            lw, kw = ll[win], k[win]
            sel = lambda v: v[win, kw]  # noqa: E731
            best_t[lw] = tm[win]
            best_i[lw] = sel(r[..., 9]).to(torch.int32)
            improved[lw] = True
            for a_row, f in zip(aux, fold):
                a_row[lw] = sel(f)

        cursor[lanes] = torch.where(hit_box, j + 1, esc[j])
        lanes = lanes[cursor[lanes] < n_nodes]

    out = (best_t, best_i, improved)
    if fold_record:
        out = out + (V3(aux[0], aux[1], aux[2]),) + tuple(aux[3:])
    if counts:
        out = out + (slabs, tests)
    return out
