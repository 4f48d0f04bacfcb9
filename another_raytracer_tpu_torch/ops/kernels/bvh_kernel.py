"""The BVH closest-hit kernel K5 (port of
``another_raytracer_tpu.ops.pallas.bvh_kernel``): the host packers of the
flat BVH and its primitive rows, and the wrapper ``bvh_closest_hit``.

* ``bvh_closest_hit`` launches the hand-written kernel ``csrc/bvh_kernel.cu``
  (built at first use, ``_build.py``) on CUDA tensors, or raises; on CPU
  tensors it runs the plain version, ``ops.bvh.traverse_packed``.
* The packers are numpy copies of the JAX package's, so the rows equal its
  rows array for array.
* ``pack_tables`` regroups a packed tree's wide (nodes, rows) into the
  kernel's compact 16-byte tables (``TABLE_COLUMNS``), once per tree: the
  scene keeps them (``SceneData.k5_tables``).  ``table_route`` picks where
  the kernel reads them, by size: a block's shared memory, or device memory.

Row formats (one row per primitive, reordered into leaf order, so a leaf is
a contiguous run of rows; ``code`` = within-kind id * 4 + primitive kind,
exact in f32 for id < 2^22):

``prim='planar'`` — triangles and the two world-space triangles each
transformed, accelerated axis-rect is split into (``models/scene._rect_quads``):
0..2 v0, 3..5 v1, 6..8 v2, 9 code; with texcoords the rows widen to 35
columns: 10..15 uv0 / uv1 / uv2, 16 material, and 17..34 the precomputed
leaf-test geometry (17..19 n = (v1-v0) x (v2-v0), 20 n.v0, 21..29 the edge
vectors m0..m2 = n x edge, 30..32 their offsets m.v, 33 1/|n|^2,
34 1/|n|).  (The JAX ``models/scene.py:166`` comment says 24 columns;
the layout is 35.)

``prim='sphere'`` — world-baked centers: 0..2 c0, 3..5 c1 - c0, 6 t0,
7 1/(t1 - t0), 8 r, 9 code, 10 material, 11 has_uv.

``prim='rect'`` — identity-transform axis rects: 0 axis, 1 k, 2 lo_u,
3 lo_v, 4 hi_u, 5 hi_v, 9 code.

Node rows ``[M, 8]``: 0..2 box min, 3..5 box max, 6 escape index, 7 leaf
meta = first * 64 + count (internal nodes have count 0).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from another_raytracer_tpu_torch.models.bvh import FlatBVH
from another_raytracer_tpu_torch.ops import bvh as bvh_ops
from another_raytracer_tpu_torch.ops import kernels
from another_raytracer_tpu_torch.ops.vec3 import V3

META_SCALE = bvh_ops.META_SCALE
PRIM_SPHERE = 0  # models/scene.py kind constant (the sphere rows' codes)
# Primitive kinds of the kernel's ``prim`` argument (csrc/bvh_kernel.cu).
PRIMS = {"planar": 0, "sphere": 1, "rect": 2}
# Threads per CUDA block, one ray per thread (measured on an H100: PERF.md,
# K5's launch shape).
BLOCK = 384
# Shared memory one block may take on sm_90 after opting in: larger tables
# are read from device memory.
MAX_SMEM = 232448


# --------------------------------------------------------------------------
# Host packing (numpy, copied from the JAX package)
# --------------------------------------------------------------------------


def pack_nodes(tree: FlatBVH) -> np.ndarray:
    """Host-side node packing -> [M,8] f32 (see module docstring)."""
    m = tree.num_nodes
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = tree.node_min
    nodes[:, 3:6] = tree.node_max
    nodes[:, 6] = tree.escape
    assert tree.leaf_count.max() < META_SCALE
    nodes[:, 7] = tree.leaf_first * META_SCALE + tree.leaf_count
    return nodes


def _leaf_rows(tree: FlatBVH, n_cols: int = 16) -> np.ndarray:
    order = tree.prim_order
    pad = max(int(tree.leaf_count.max()), 1)
    return np.zeros((order.shape[0] + pad, n_cols), np.float32)


def pack_planar(tree: FlatBVH, v0, v1, v2, codes, uv0=None, uv1=None,
                uv2=None, mats=None) -> tuple:
    """(nodes [M,8], rows [N+pad,16 or 35]) for the planar kernel.

    ``codes``: [N] int array, ``id * 4 + kind`` per primitive in build order.
    Rows are reordered into leaf order (tree.prim_order); trailing pad rows
    are all-zero (degenerate normal -> never hit).  ``uv0/uv1/uv2`` ([N,2])
    and ``mats`` ([N]), when given, widen the rows to 35 columns: the
    texcoords and material of the full winner-record fold and the
    precomputed leaf-test geometry."""
    codes = np.asarray(codes, np.int64)
    assert codes.max(initial=0) < (1 << 24), "code must be exact in f32"
    order = tree.prim_order
    n = order.shape[0]
    full = uv0 is not None
    rows = _leaf_rows(tree, 35 if full else 16)
    rows[:n, 0:3] = np.asarray(v0)[order]
    rows[:n, 3:6] = np.asarray(v1)[order]
    rows[:n, 6:9] = np.asarray(v2)[order]
    rows[:n, 9] = codes[order]
    if full:
        rows[:n, 10:12] = np.asarray(uv0)[order]
        rows[:n, 12:14] = np.asarray(uv1)[order]
        rows[:n, 14:16] = np.asarray(uv2)[order]
        assert np.asarray(mats).max(initial=0) < (1 << 24)
        rows[:n, 16] = np.asarray(mats, np.int64)[order]
        # Precomputed per-triangle leaf-test geometry (cols 17-34), in f32.
        # Pad rows stay zero: n = 0 -> ndotd = 0 -> never hit.
        f1 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        av0, av1, av2 = f1(rows[:n, 0:3]), f1(rows[:n, 3:6]), f1(rows[:n, 6:9])
        nn = np.cross(av1 - av0, av2 - av0).astype(np.float32)
        m0 = np.cross(nn, av1 - av0).astype(np.float32)
        m1 = np.cross(nn, av2 - av1).astype(np.float32)
        m2 = np.cross(nn, av0 - av2).astype(np.float32)
        n2 = (nn * nn).sum(1)
        rows[:n, 17:20] = nn
        rows[:n, 20] = (nn * av0).sum(1)
        rows[:n, 21:24] = m0
        rows[:n, 24:27] = m1
        rows[:n, 27:30] = m2
        rows[:n, 30] = (m0 * av0).sum(1)
        rows[:n, 31] = (m1 * av1).sum(1)
        rows[:n, 32] = (m2 * av2).sum(1)
        rows[:n, 33] = 1.0 / np.maximum(n2, 1e-37)
        rows[:n, 34] = 1.0 / np.sqrt(np.maximum(n2, 1e-37))
    return pack_nodes(tree), rows


def pack_rects(tree: FlatBVH, axis, k, lo, hi, codes) -> tuple:
    """(nodes [M,8], rows [N+pad,16]) for the rect kernel (identity-transform
    axis rects only).  Pad rows get inverted u-bounds (lo_u=1 > hi_u=0) so
    they can never test inside."""
    codes = np.asarray(codes, np.int64)
    assert codes.max(initial=0) < (1 << 24)
    order = tree.prim_order
    n = order.shape[0]
    rows = _leaf_rows(tree)
    rows[:n, 0] = np.asarray(axis, np.float64)[order]
    rows[:n, 1] = np.asarray(k, np.float64)[order]
    rows[:n, 2] = np.asarray(lo, np.float64)[order, 0]
    rows[:n, 3] = np.asarray(lo, np.float64)[order, 1]
    rows[:n, 4] = np.asarray(hi, np.float64)[order, 0]
    rows[:n, 5] = np.asarray(hi, np.float64)[order, 1]
    rows[:n, 9] = codes[order]
    rows[n:, 2] = 1.0  # lo_u > hi_u: unhittable pad
    return pack_nodes(tree), rows


def pack_spheres(tree: FlatBVH, c0_w, c1_w, t0, t1, r, mats=None,
                 has_uv=None) -> tuple:
    """(nodes [M,8], rows [N+pad,16]) for the sphere kernel.  Centers are
    WORLD-space (transforms baked); zero pad rows are never hit (r = 0 gives
    disc <= 0 by Cauchy-Schwarz).  ``mats``/``has_uv``, when given, fill
    cols 10/11 for the winner-record fold."""
    order = tree.prim_order
    n = order.shape[0]
    assert n < (1 << 22)
    rows = _leaf_rows(tree)
    if mats is not None:
        assert np.asarray(mats).max(initial=0) < (1 << 24)
        rows[:n, 10] = np.asarray(mats, np.int64)[order]
        rows[:n, 11] = np.asarray(has_uv, np.float64)[order]
    c0_w = np.asarray(c0_w, np.float64)[order]
    c1_w = np.asarray(c1_w, np.float64)[order]
    t0 = np.asarray(t0, np.float64)[order]
    t1 = np.asarray(t1, np.float64)[order]
    rows[:n, 0:3] = c0_w
    rows[:n, 3:6] = c1_w - c0_w
    rows[:n, 6] = t0
    dt = t1 - t0
    rows[:n, 7] = np.where(dt != 0.0, 1.0 / np.where(dt != 0.0, dt, 1.0), 0.0)
    rows[:n, 8] = np.asarray(r, np.float64)[order]
    rows[:n, 9] = order * 4 + PRIM_SPHERE
    return pack_nodes(tree), rows


# The compact tables (csrc/bvh_kernel.cu): per node two float4 of wide
# node columns, per leaf row the float4s of its layout, by (prim, precomp);
# None is a zero.  The same floats as the wide rows, regrouped.
NODE_COLUMNS = ((0, 1, 2, 6), (3, 4, 5, 7))
TABLE_COLUMNS = {
    # (v0, -), (v1, -), (v2, -)
    ("planar", False): ((0, 1, 2, None), (3, 4, 5, None), (6, 7, 8, None)),
    # (n, n.v0), (m0, c0), (m1, c1), (m2, c2)
    ("planar", True): ((17, 18, 19, 20), (21, 22, 23, 30), (24, 25, 26, 31),
                       (27, 28, 29, 32)),
    # (c0, r), (c1 - c0, t0), (1/dt, -, -, -): K3's sphere layout too
    ("sphere", False): ((0, 1, 2, 8), (3, 4, 5, 6), (7, None, None, None)),
    # (axis, k, lo_u, lo_v), (hi_u, hi_v, -, -)
    ("rect", False): ((0, 1, 2, 3), (4, 5, None, None)),
}


def _regroup(a, groups):
    """[R, C] -> [R * len(groups), 4]: each row's columns ``groups``."""
    zero = torch.zeros_like(a[:, :1])
    f4 = [torch.cat([a[:, c:c + 1] if c is not None else zero for c in g], 1)
          for g in groups]
    return torch.stack(f4, 1).reshape(-1, 4)


def pack_tables(nodes, rows, prim: str, precomp: bool = False):
    """The compact tables of a packed tree, [2M + S N, 4] f32 on the tree's
    device (float4 rows, 16-byte aligned): per node (lo.xyz, escape) |
    (hi.xyz, meta), then per leaf-order row the S float4s of
    ``TABLE_COLUMNS[prim, precomp]``, pad rows included."""
    nodes, rows = nodes.to(torch.float32), rows.to(torch.float32)
    return torch.cat([_regroup(nodes, NODE_COLUMNS),
                      _regroup(rows, TABLE_COLUMNS[prim, precomp])]
                     ).contiguous()


def table_route(tables) -> str:
    """"shared" where the compact tables fit a block's shared memory (each
    block copies them there once), else "global" (device memory)."""
    return "shared" if tables.numel() * 4 <= MAX_SMEM else "global"


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------


def bvh_closest_hit(nodes, rows, o: V3, d: V3, init_t, init_idx, *,
                    leaf_size: int, t_min: float = 1e-3, prim: str = "planar",
                    time=None, fold_record: bool = False,
                    fold_full: bool = False, precomp: bool = False,
                    tables=None):
    """Closest hit over a packed BVH (the JAX ``bvh_closest_hit``'s
    arguments and return contract, less its TPU block and interpret knobs).

    Args:
      nodes: [M,8] f32 packed nodes; rows: [N+pad, 16 or 35] f32 leaf-ordered
        primitive rows (module docstring).
      o, d: V3 of [B] f32 ray components; time: [B] ray times (sphere lerp;
        zeros when None).
      init_t: [B] current best t; init_idx: [B] current best code (copied
        through where the tree does not improve it).
      leaf_size: the build's leaf size (a leaf's count above it is cut).
      t_min: a Python float, fixed per call as the TPU kernel bakes it in.
      tables: ``pack_tables(nodes, rows, prim, precomp)`` where the caller
        keeps them (the scene does); packed here when None.
    Returns (t [B], code [B] int32, improved [B] bool), then the fold
    outputs of ``fold_record`` (planar: unit normal V3, u, v, and with
    ``fold_full`` tu, tv, mat as f32; sphere: centre at the ray's time V3,
    radius, mat, has_uv), zeros where not improved.  CUDA tensors launch
    ``csrc/bvh_kernel.cu``; CPU tensors run ``ops.bvh.traverse_packed``.
    """
    if isinstance(t_min, torch.Tensor):
        raise TypeError("t_min must be a Python float: the kernel fixes it "
                        "per launch, as the TPU kernel bakes it in")
    bvh_ops.check_variant(rows, prim, fold_record, fold_full, precomp)
    dev = o.x.device
    if dev.type == "cpu":
        return bvh_ops.traverse_packed(
            nodes, rows, o, d, time, float(t_min), init_t, init_idx,
            leaf_size=leaf_size, prim=prim, fold_record=fold_record,
            fold_full=fold_full, precomp=precomp)
    if dev.type != "cuda":
        raise ValueError(f"no BVH kernel for device {dev}")
    run, outputs = prepare_launch(
        nodes, rows, o, d, init_t, init_idx, leaf_size=leaf_size,
        t_min=t_min, prim=prim, time=time, fold_record=fold_record,
        fold_full=fold_full, precomp=precomp, tables=tables)
    with torch.cuda.device(dev):
        err = run()
    if err != 0:
        raise RuntimeError(f"bvh_kernel launch failed: CUDA error {err}")
    if o.x.shape[0]:
        kernels.count(f"K5/{prim}/{run.route}")
    t, code, hit, aux = outputs
    out = (t, code, hit)
    if fold_record:
        out = out + (V3(aux[0], aux[1], aux[2]),) + tuple(aux[3:])
    return out


def _lib(target="bvh_kernel"):
    """The built kernel library (``target``: a ``_build.TARGETS`` build of
    ``csrc/bvh_kernel.cu``); the counting build exports ``art_bvh_count``."""
    from another_raytracer_tpu_torch.ops.kernels import _build

    lib = _build.load(target)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    args = ([P, I, P, I, I, I] + [P] * 9
            + [I, I, F, I, I, I, I, I, P, P, P, P])
    if target == "bvh_kernel_count":
        lib.art_bvh_count.argtypes = args + [P, P, P]
        lib.art_bvh_count.restype = I
    else:
        lib.art_bvh_closest_hit.argtypes = args + [P]
        lib.art_bvh_closest_hit.restype = I
    return lib


# The counting build's totals, in the order csrc/bvh_kernel.cu adds them:
# slab tests, the warp steps of the slab loop and their active lanes, leaf
# row tests, the warp steps of the leaf-row loop and their active lanes.
TALLIES = ("slab_tests", "slab_steps", "slab_active", "leaf_tests",
           "leaf_steps", "leaf_active")


def tallies(nodes, rows, o: V3, d: V3, init_t, init_idx, **kw):
    """K5's counting instance on CUDA rays (a measurement; the port's paths
    never launch it): the same walk and outputs as ``bvh_closest_hit``, with
    the arguments of ``prepare_launch``, and per launch the ``TALLIES``,
    the active-lane shares ``slab_simt`` and ``leaf_simt`` (active lanes /
    (32 x warp steps)), the ``blocks`` that ran and the launch's
    ``tail_share``, ``slots`` and ``launch_ms`` (``mega_kernel.tail_share``
    of per-block ``%globaltimer`` stamps).  Returns (t, code, improved,
    {tally: value})."""
    from another_raytracer_tpu_torch.ops.kernels.mega_kernel import tail_share

    if o.x.device.type != "cuda":
        raise ValueError("the counting instance needs CUDA tensors")
    run, (t, code, hit, _aux, totals, times) = prepare_launch(
        nodes, rows, o, d, init_t, init_idx, tally=True, **kw)
    with torch.cuda.device(o.x.device):
        err = run()
    if err != 0:
        raise RuntimeError(f"bvh_kernel count launch failed: CUDA error {err}")
    tl = dict(zip(TALLIES, totals.tolist()))
    tl["slab_simt"] = tl["slab_active"] / max(32 * tl["slab_steps"], 1)
    tl["leaf_simt"] = tl["leaf_active"] / max(32 * tl["leaf_steps"], 1)
    times = times.cpu()
    tl["blocks"] = int((times[:, 0] > 0).sum())
    tl["tail_share"], tl["slots"], tl["launch_ms"] = tail_share(times)
    return t, code, hit, tl


def _f32(x, n, dev, what):
    if x.shape != (n,) or x.device != dev:
        raise ValueError(f"{what} must be a [{n}] tensor on {dev}")
    return x.to(torch.float32).contiguous()


def prepare_launch(nodes, rows, o: V3, d: V3, init_t, init_idx, *,
                   leaf_size, t_min, prim, time=None, fold_record=False,
                   fold_full=False, precomp=False, tables=None, route=None,
                   block=BLOCK, tally=False):
    """Everything one CUDA launch needs: returns (run, (t, code, hit, aux)).
    ``run()`` is the bare launch and returns the CUDA error code;
    ``run.route`` is the table route it takes.
    ``tables``: as ``bvh_closest_hit``'s.  ``route`` ("shared" / "global")
    overrides ``table_route``'s choice (a small tree can take the
    device-memory walk); ``block`` is the launch's threads per block (each
    ray's outputs are the same bits at any).  ``tally`` launches the
    counting build, whose outputs add the u64 totals of ``TALLIES`` (as
    int64) and each block's start and end time ([blocks, 2] int64 ns)."""
    bvh_ops.check_variant(rows, prim, fold_record, fold_full, precomp)
    dev = o.x.device
    n = o.x.shape[0]
    if nodes.dim() != 2 or nodes.shape[1] != 8 or rows.dim() != 2:
        raise ValueError("nodes must be [M, 8] and rows 2-D")
    if nodes.device != dev or rows.device != dev:
        raise ValueError("nodes, rows and rays must be on one device")
    if not 0 < leaf_size < META_SCALE:
        raise ValueError(f"leaf_size must be in [1, {META_SCALE - 1}]")
    if tables is None:
        tables = pack_tables(nodes, rows, prim, precomp)
    per_row = len(TABLE_COLUMNS[prim, precomp])
    if (tables.shape != (2 * nodes.shape[0] + per_row * rows.shape[0], 4)
            or tables.dtype != torch.float32 or tables.device != dev
            or not tables.is_contiguous()):
        raise ValueError("tables must be pack_tables(nodes, rows, prim, "
                         "precomp)")
    route = table_route(tables) if route is None else route
    if route not in ("shared", "global") or (
            route == "shared" and table_route(tables) != "shared"):
        raise ValueError(f"no {route!r} route for {tables.numel() * 4} B of "
                         f"tables")
    ins = [_f32(c, n, dev, "ray components") for c in (*o, *d)]
    ins.append(_f32(torch.zeros_like(o.x) if time is None else time, n, dev,
                    "time"))
    ins.append(_f32(init_t, n, dev, "init_t"))
    if init_idx.shape != (n,) or init_idx.device != dev:
        raise ValueError(f"init_idx must be a [{n}] tensor on {dev}")
    ins.append(init_idx.to(torch.int32).contiguous())
    rows_c = rows.to(torch.float32).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    code = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    aux = torch.empty((bvh_ops.n_aux(prim, fold_record, fold_full), n),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (tables, int(route == "shared"), rows_c, nodes.shape[0],
            rows_c.shape[0], rows_c.shape[1], *ins, n, int(leaf_size),
            float(t_min), PRIMS[prim], int(fold_record), int(fold_full),
            int(precomp), int(block), t, code, hit, aux)
    outputs = (t, code, hit, aux)
    if tally:
        entry = _lib("bvh_kernel_count").art_bvh_count
        totals = torch.zeros(len(TALLIES), dtype=torch.int64, device=dev)
        times = torch.zeros((max(-(-n // int(block)), 1), 2),
                            dtype=torch.int64, device=dev)
        args += (totals, times)
        outputs += (totals, times)
    else:
        entry = _lib().art_bvh_closest_hit
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args) + (stream,)

    def run(_inputs=args):  # the default keeps the tensors behind ptrs alive
        return entry(*ptrs)

    run.route = route
    return run, outputs
