"""The BVH closest-hit kernel K5 (port of
``another_raytracer_tpu.ops.pallas.bvh_kernel``): the host packers of the
flat BVH and its primitive rows, and the wrapper ``bvh_closest_hit``.

* ``bvh_closest_hit`` launches the hand-written kernel ``csrc/bvh_kernel.cu``
  (built at first use, ``_build.py``) on CUDA tensors, or raises; on CPU
  tensors it runs the plain version, ``ops.bvh.traverse_packed``.
* The packers are numpy copies of the JAX package's, so the rows equal its
  rows array for array.

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
from another_raytracer_tpu_torch.ops.vec3 import V3

META_SCALE = bvh_ops.META_SCALE
PRIM_SPHERE = 0  # models/scene.py kind constant (the sphere rows' codes)
# Primitive kinds of the kernel's ``prim`` argument (csrc/bvh_kernel.cu).
PRIMS = {"planar": 0, "sphere": 1, "rect": 2}
# Threads per CUDA block (one thread per ray).
BLOCK = 128


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


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------


def bvh_closest_hit(nodes, rows, o: V3, d: V3, init_t, init_idx, *,
                    leaf_size: int, t_min: float = 1e-3, prim: str = "planar",
                    time=None, fold_record: bool = False,
                    fold_full: bool = False, precomp: bool = False):
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
    Returns (t [B], code [B] int32, improved [B] bool), then the fold
    outputs of ``fold_record`` (planar: unit normal V3, u, v, and with
    ``fold_full`` tu, tv, mat as f32; sphere: outward normal V3, mat,
    has_uv), zeros where not improved.  CUDA tensors launch
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
        fold_full=fold_full, precomp=precomp)
    with torch.cuda.device(dev):
        err = run()
    if err != 0:
        raise RuntimeError(f"bvh_kernel launch failed: CUDA error {err}")
    if o.x.shape[0]:
        bvh_closest_hit.launches += 1
    t, code, hit, aux = outputs
    out = (t, code, hit)
    if fold_record:
        out = out + (V3(aux[0], aux[1], aux[2]),) + tuple(aux[3:])
    return out


# Launches of the CUDA kernel, incremented once per launch and nowhere else.
bvh_closest_hit.launches = 0


def _lib(target="bvh_kernel"):
    """The built kernel library (``target``: a ``_build.TARGETS`` build of
    ``csrc/bvh_kernel.cu``)."""
    from another_raytracer_tpu_torch.ops.kernels import _build

    lib = _build.load(target)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.art_bvh_closest_hit.argtypes = (
        [P, I, P, I, I] + [P] * 9 + [I, I, F, I, I, I, I, I, P, P, P, P, P])
    lib.art_bvh_closest_hit.restype = I
    return lib


def _f32(x, n, dev, what):
    if x.shape != (n,) or x.device != dev:
        raise ValueError(f"{what} must be a [{n}] tensor on {dev}")
    return x.to(torch.float32).contiguous()


def prepare_launch(nodes, rows, o: V3, d: V3, init_t, init_idx, *,
                   leaf_size, t_min, prim, time=None, fold_record=False,
                   fold_full=False, precomp=False):
    """Everything one CUDA launch needs: returns (run, (t, code, hit, aux)).
    ``run()`` is the bare launch and returns the CUDA error code."""
    bvh_ops.check_variant(rows, prim, fold_record, fold_full, precomp)
    dev = o.x.device
    n = o.x.shape[0]
    if nodes.dim() != 2 or nodes.shape[1] != 8 or rows.dim() != 2:
        raise ValueError("nodes must be [M, 8] and rows 2-D")
    if nodes.device != dev or rows.device != dev:
        raise ValueError("nodes, rows and rays must be on one device")
    if not 0 < leaf_size < META_SCALE:
        raise ValueError(f"leaf_size must be in [1, {META_SCALE - 1}]")
    ins = [_f32(c, n, dev, "ray components") for c in (*o, *d)]
    ins.append(_f32(torch.zeros_like(o.x) if time is None else time, n, dev,
                    "time"))
    ins.append(_f32(init_t, n, dev, "init_t"))
    if init_idx.shape != (n,) or init_idx.device != dev:
        raise ValueError(f"init_idx must be a [{n}] tensor on {dev}")
    ins.append(init_idx.to(torch.int32).contiguous())
    nodes_c = nodes.to(torch.float32).contiguous()
    rows_c = rows.to(torch.float32).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=dev)
    code = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    aux = torch.empty((bvh_ops.n_aux(fold_record, fold_full), n),
                      dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (nodes_c, nodes_c.shape[0], rows_c, rows_c.shape[0],
            rows_c.shape[1], *ins, n, int(leaf_size), float(t_min),
            PRIMS[prim], int(fold_record), int(fold_full), int(precomp),
            BLOCK, t, code, hit, aux)
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args) + (stream,)

    def run(_inputs=args):  # the default keeps the tensors behind ptrs alive
        return lib.art_bvh_closest_hit(*ptrs)

    return run, (t, code, hit, aux)
