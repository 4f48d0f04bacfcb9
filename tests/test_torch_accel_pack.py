"""The accel walk's compact tables, the wrapper's choice between its two
walks, and a model of the postponed-leaf schedule (CPU, no card), which K3
and K5 (csrc/bvh_kernel.cu, on sphere, rect and planar trees) share.

K3's CUDA walk (csrc/mega_kernel.cu) reads ``pack_accel_tables`` from a
block's shared memory where they fit, else from device memory, and
postpones leaves warp-wide: a lane advances over inner nodes until it holds
a leaf whose box it hit, and the warp tests leaves only when no lane is
still looking.  ``_postponed_walk`` runs that schedule on a warp of rays in
float32 scalar arithmetic, op for op the kernel's; it must visit, per lane,
the nodes and leaves of the per-lane stackless walk and end with
``ops/bvh.traverse_packed``'s winner, t bits and work counts.
"""

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import bvh as bvh_ops
from another_raytracer_tpu_torch.ops import camera
from another_raytracer_tpu_torch.ops.kernels import bvh_kernel
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from another_raytracer_tpu_torch.ops.vec3 import V3
from chip_smoke import bvh_sphere_scene, many_spheres_scene

torch.set_num_threads(1)

SCENES = {"random_scene": library.random_scene,
          "bvh_sphere_scene": bvh_sphere_scene}
F = np.float32
BIG = F(3e37)
T_MIN = F(1e-3)


@pytest.mark.parametrize("name", list(SCENES))
def test_compact_tables_regroup_nodes_and_rows(name):
    scene, _ = SCENES[name](device="cpu")
    tab = tmk.pack_accel_tables(scene).numpy()
    nodes = scene.sph_bvh_nodes.numpy()
    rows = tmk.pack_accel_rows(scene).numpy()
    m, n = nodes.shape[0], rows.shape[0]
    assert tab.dtype == np.float32 and tab.shape == (2 * m + 3 * n, 4)
    node4 = tab[:2 * m].reshape(m, 2, 4)
    sph4 = tab[2 * m:].reshape(n, 3, 4)
    # Nodes: (lo.xyz, escape) | (hi.xyz, meta).
    for (k, c), col in zip([(0, 0), (0, 1), (0, 2), (0, 3),
                            (1, 0), (1, 1), (1, 2), (1, 3)],
                           [0, 1, 2, 6, 3, 4, 5, 7]):
        np.testing.assert_array_equal(node4[:, k, c], nodes[:, col])
    # Spheres: (c0.xyz, r) | (c1 - c0, t0) | (1/dt, 0, 0, 0), leaf order,
    # pad rows included.
    for (k, c), col in zip([(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1),
                            (1, 2), (1, 3), (2, 0)],
                           [0, 1, 2, 8, 3, 4, 5, 6, 7]):
        np.testing.assert_array_equal(sph4[:, k, c], rows[:, col])
    assert not sph4[:, 2, 1:].any()


def test_walk_choice_by_table_size():
    scene1, _ = library.random_scene(device="cpu")
    assert (scene1.n_sph_bvh_nodes, scene1.sph_bvh_rows.shape[0]) == (55, 903)
    assert tmk.accel_smem_bytes(scene1) == 45104
    assert tmk.accel_walk(scene1) == "shared"
    assert tmk.accel_walk(bvh_sphere_scene("cpu")[0]) == "shared"
    big, _ = many_spheres_scene("cpu")
    assert tmk.accel_smem_bytes(big) > tmk.MAX_SMEM
    assert tmk.accel_walk(big) == "global"


def test_trees_above_the_row_limit_raise():
    huge, params = many_spheres_scene("cpu", n=tmk.ACCEL_MAX_ROWS + 10)
    assert huge.sph_bvh_rows.shape[0] > tmk.ACCEL_MAX_ROWS
    with pytest.raises(ValueError, match="at most"):
        tmk.accel_walk(huge)
    cam = camera.make_camera(aspect_ratio=4 / 3, device="cpu", **params)
    assert not tmk.supports_accel(huge, cam)
    with pytest.raises(ValueError, match="not supported"):
        tmk.trace_regenerative_mega(
            huge, cam, torch.arange(12), torch.zeros(12, dtype=torch.int64),
            0, width=4, height=3, sample_stride=1, sample_end=1, spp_cap=1,
            max_depth=2, t_min=1e-3)


def _slab(node, o, inv, best_t):
    tn, tf = T_MIN, best_t
    for c in range(3):
        a = (node[c] - o[c]) * inv[c]
        b = (node[3 + c] - o[c]) * inv[c]
        tn = max(tn, min(a, b))
        tf = min(tf, max(a, b))
    return tn < tf


def _sphere_t(r, o, d, tm, best_t):
    """The sphere test (csrc/bvh_kernel.cu, csrc/mega_kernel.cu): t, or
    None where the ray misses."""
    a_len = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    inv_a = F(1) / (a_len if a_len > 0 else F(1))
    frac = (tm - r[6]) * r[7]
    oc = [o[c] - (r[c] + frac * r[3 + c]) for c in range(3)]
    half_b = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
    cc = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r[8] * r[8]
    disc = half_b * half_b - a_len * cc
    if not disc > 0:
        return None
    sq = np.sqrt(disc)
    root1 = (-half_b - sq) * inv_a
    return root1 if T_MIN < root1 < best_t else (-half_b + sq) * inv_a


def _rect_t(r, o, d, tm, best_t):
    """The identity axis-rect test (csrc/bvh_kernel.cu)."""
    is0, is2 = r[0] == 0, r[0] == 2
    o_ax = o[0] if is0 else (o[2] if is2 else o[1])
    d_ax = d[0] if is0 else (d[2] if is2 else d[1])
    if d_ax == 0:
        return None
    t = (r[1] - o_ax) / d_ax
    pu = (o[1] if is0 else o[0]) + t * (d[1] if is0 else d[0])
    pv = (o[1] if is2 else o[2]) + t * (d[1] if is2 else d[2])
    return t if r[2] <= pu <= r[4] and r[3] <= pv <= r[5] else None


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _planar_t(r, o, d, tm, best_t):
    """The triangle test from the vertices (csrc/bvh_kernel.cu)."""
    v0, v1, v2 = list(r[0:3]), list(r[3:6]), list(r[6:9])
    sub = lambda a, b: [a[c] - b[c] for c in range(3)]  # noqa: E731
    n = _cross(sub(v1, v0), sub(v2, v0))
    m = [_cross(n, sub(v1, v0)), _cross(n, sub(v2, v1)), _cross(n, sub(v0, v2))]
    c = [_dot(m[0], v0), _dot(m[1], v1), _dot(m[2], v2)]
    ndotd = _dot(n, d)
    if ndotd == 0:
        return None
    t = (_dot(n, v0) - _dot(n, o)) / ndotd
    p = [o[k] + d[k] * t for k in range(3)]
    return t if all(_dot(p, m[k]) - c[k] >= 0 for k in range(3)) else None


TESTS = {"sphere": _sphere_t, "rect": _rect_t, "planar": _planar_t}


def _leaf(rows, meta, leaf_size, o, d, tm, best_t, best, prim="sphere"):
    """A leaf's rows in leaf order (the kernels' leaf_test)."""
    count = min(meta % bvh_ops.META_SCALE, leaf_size)
    first = meta // bvh_ops.META_SCALE
    for k in range(count):
        row = min(first + k, rows.shape[0] - 1)
        with np.errstate(all="ignore"):
            t = TESTS[prim](rows[row], o, d, tm, best_t)
        if t is not None and T_MIN < t < best_t:
            best_t, best = t, row
    return best_t, best, count


def _postponed_walk(nodes, rows, leaf_size, rays, prim="sphere"):
    """The kernel's while-while schedule over one warp of rays.  Returns
    per lane (best t, best row, visit trace, slab tests, sphere tests) and
    the warp's leaf rounds."""
    lanes = []
    for o, d, tm in rays:
        inv = [F(1) / (c if abs(c) >= F(1e-20) else
                       (F(-1e-20) if c < 0 else F(1e-20))) for c in d]
        lanes.append(dict(o=o, d=d, tm=tm, inv=inv, j=0, best_t=BIG,
                          best=-1, trace=[], slabs=0, tests=0))
    rounds = 0
    while True:
        # Each lane alone: inner nodes until it stands on a hit leaf.
        for ln in lanes:
            ln["leaf"] = -1
            while ln["j"] < nodes.shape[0]:
                j = ln["j"]
                ln["slabs"] += 1
                ln["trace"].append(("node", j))
                if not _slab(nodes[j], ln["o"], ln["inv"], ln["best_t"]):
                    ln["j"] = int(nodes[j, 6])
                    continue
                ln["j"] = j + 1
                if int(nodes[j, 7]) % bvh_ops.META_SCALE:
                    ln["leaf"] = j
                    break
        # __any_sync: the warp stops when no lane holds a leaf.
        if not any(ln["leaf"] >= 0 for ln in lanes):
            break
        rounds += 1
        for ln in lanes:
            if ln["leaf"] >= 0:
                ln["trace"].append(("leaf", ln["leaf"]))
                ln["best_t"], ln["best"], n = _leaf(
                    rows, int(nodes[ln["leaf"], 7]), leaf_size, ln["o"],
                    ln["d"], ln["tm"], ln["best_t"], ln["best"], prim)
                ln["tests"] += n
    return lanes, rounds


def _per_lane_trace(nodes, leaf_size, rows, o, d, tm, prim="sphere"):
    """The visits of the plain per-lane stackless walk (one ray alone)."""
    inv = [F(1) / (c if abs(c) >= F(1e-20) else
                   (F(-1e-20) if c < 0 else F(1e-20))) for c in d]
    j, best_t, best, trace = 0, BIG, -1, []
    while j < nodes.shape[0]:
        trace.append(("node", j))
        if not _slab(nodes[j], o, inv, best_t):
            j = int(nodes[j, 6])
            continue
        if int(nodes[j, 7]) % bvh_ops.META_SCALE:
            trace.append(("leaf", j))
            best_t, best, _ = _leaf(rows, int(nodes[j, 7]), leaf_size, o, d,
                                    tm, best_t, best, prim)
        j += 1
    return trace


def _check_schedule(nodes, rows, leaf, o, d, tm, prim):
    """Two warps of rays through the postponed schedule: each ray's visits
    are the per-lane walk's, and its winner, t bits and work counts are
    ``traverse_packed``'s."""
    got = []
    for w in range(2):
        sl = slice(32 * w, 32 * w + 32)
        warp, rounds = _postponed_walk(
            nodes, rows, leaf, list(zip(o[sl], d[sl], tm[sl])), prim)
        got += warp
        # Postponing batches the warp's leaves: fewer rounds than leaf tests.
        assert rounds < sum(1 for ln in warp for v in ln["trace"]
                            if v[0] == "leaf")
    for k, ln in enumerate(got):
        assert ln["trace"] == _per_lane_trace(nodes, leaf, rows, o[k], d[k],
                                              tm[k], prim)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    want_t, code, improved, slabs, tests = bvh_ops.traverse_packed(
        t(nodes), t(rows), V3(*map(t, o.T)), V3(*map(t, d.T)), t(tm), 1e-3,
        torch.full((64,), 3e37), torch.zeros(64, dtype=torch.int32),
        leaf_size=leaf, prim=prim, counts=True)
    best_t = np.array([ln["best_t"] for ln in got], F)
    np.testing.assert_array_equal(best_t, want_t.numpy())
    best = np.array([ln["best"] for ln in got])
    np.testing.assert_array_equal(best >= 0, improved.numpy())
    np.testing.assert_array_equal(rows[best[best >= 0], 9],
                                  code.numpy()[best >= 0])
    np.testing.assert_array_equal([ln["slabs"] for ln in got], slabs.numpy())
    np.testing.assert_array_equal([ln["tests"] for ln in got], tests.numpy())
    assert improved.any() and not improved.all()


@pytest.mark.parametrize("name", list(SCENES))
def test_postponed_schedule_visits_the_per_lane_walk(name):
    scene, params = SCENES[name](device="cpu")
    nodes = scene.sph_bvh_nodes.numpy()
    rows = scene.sph_bvh_rows.numpy()
    # Two warps of rays: camera rays of a few pixels and random rays through
    # the scene, with random shutter times.
    g = np.random.default_rng(7)
    cam = camera.make_camera(aspect_ratio=4 / 3, device="cpu", **params)
    pix = torch.from_numpy(g.integers(0, 40 * 30, 32))
    o_c, d_c, _ = camera.generate_rays(cam, pix, torch.zeros_like(pix), 40,
                                       30, 0)
    o = np.concatenate([np.stack([c.numpy() for c in o_c], 1),
                        g.uniform((-8, 0.1, -8), (8, 2, 8), (32, 3))])
    d = np.concatenate([np.stack([c.numpy() for c in d_c], 1),
                        g.normal(size=(32, 3))])
    o, d = o.astype(F), d.astype(F)
    tm = g.uniform(0, 1, 64).astype(F)
    _check_schedule(nodes, rows, scene.bvh_leaf_size, o, d, tm, "sphere")


@pytest.mark.parametrize("prim", ["rect", "planar"])
def test_postponed_schedule_on_rect_and_planar_trees(prim):
    """K5's walk of its other two tree kinds: 300 rects or triangles in a
    leaf-16 tree, rays from inside their box toward random directions."""
    g = np.random.default_rng(5)
    if prim == "planar":
        base = g.uniform(-5, 5, (300, 3))
        v = [base] + [base + g.uniform(-1.5, 1.5, (300, 3)) for _ in range(2)]
        tree = bvh_lib.build(*bvh_lib.triangle_bounds(*v), leaf_size=16)
        nodes, rows = bvh_kernel.pack_planar(tree, *v, np.arange(300) * 4 + 2)
    else:
        axis = g.integers(0, 3, 300)
        lo = g.uniform(-5, 4, (300, 2))
        k = g.uniform(-5, 5, 300)
        tree = bvh_lib.build(*bvh_lib.rect_bounds(axis, k, lo, lo + 1.5),
                             leaf_size=16)
        nodes, rows = bvh_kernel.pack_rects(tree, axis, k, lo, lo + 1.5,
                                            np.arange(300) * 4 + 1)
    o = g.uniform(-6, 6, (64, 3)).astype(F)
    d = g.normal(size=(64, 3)).astype(F)
    _check_schedule(nodes, rows, 16, o, d, np.zeros(64, F), prim)
