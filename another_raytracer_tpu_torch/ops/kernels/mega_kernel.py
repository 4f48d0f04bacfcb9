"""The forward megakernel: the ENTIRE regenerating forward wavefront in one
kernel (port of ``another_raytracer_tpu.ops.pallas.mega_kernel``), in its
sweep mode (K1, record instance K2) and its accel mode (K3, forward and
record instances).

Per ray lane the kernel runs camera ray generation (engine.h:58-68 +
camera.h:38-47), counter-based threefry draws (ops/rng.py), the closest hit,
lambertian / metal / dielectric / diffuse-light shading with solid / checker
textures, and per-lane sample regeneration until the lane's samples are
spent.  The closest hit is, per mode:

* sweep (``supports``): every world-baked primitive row (spheres first, then
  rects — the fold order of intersect.closest_hit), strict ``t < best_t``;
* accel (``supports_accel``; the scene has one sphere tree and nothing else):
  a walk of the sphere BVH (``scene.sph_bvh_nodes``) over the widened leaf
  rows of ``pack_accel_rows``.  The TPU kernel walks a block of lanes with
  ONE cursor (a packet DFS, mega_kernel.py:429-500 there): at node j every
  lane runs the slab test, the block enters the subtree if any lane hit the
  box, and a lane's leaf tests are masked by its own box test.  Child boxes
  nest inside their parents and a lane's best t only shrinks, so a lane that
  missed a box misses every box below it: the leaves a lane tests, and their
  order, are those of its own stackless walk over the escape indices (the
  argument of the BVH kernel K5, ``ops/bvh.py``).  Here every lane walks on
  its own; within a leaf the strict ``t < best_t`` rule keeps the earlier
  row on a tie; the winner's material columns are read once after the walk,
  which is what the TPU kernel's per-improvement material fold leaves
  behind.  K3's own arithmetic: dead lanes are parked (origin 1e8, direction
  0; here they do not walk at all, which tests nothing either), the slab
  starts at ``[t_min, best_t]``, and ``1/r`` is taken as
  ``1/where(r != 0, r, 1)``.  Not K3's: in both modes a sphere winner's hit
  point and normal are re-projected onto its sphere
  (``intersect._onto_sphere``), as the wavefront's records are, where the
  JAX kernel takes ``o + t d`` and ``(o + t d - c) / r``.
  The CUDA walk reads the compact tables of ``pack_accel_tables`` from
  shared memory where they fit a block (``accel_walk``), else from device
  memory, and postpones leaves warp-wide (csrc/mega_kernel.cu); each lane's
  visits, and so its result, are those of the per-lane walk.

* ``trace_regenerative_mega`` is the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/mega_kernel.cu`` (built at first use, see
  ``_build.py``) or raises; on CPU tensors it runs the plain version.
* ``trace_regenerative_mega_reference`` is the plain PyTorch version: the
  same per-lane algorithm as vectorised tensor ops on ``[B]`` lanes, with the
  same rows, keys and fold order (the accel walk through
  ``ops.bvh.traverse_packed``, the plain version of K5, whose sphere test is
  K3's; the winner re-projected from its row and t).  It runs on any
  device; the CPU tests hold it against the JAX kernel in interpret mode
  (with the re-projection patched out: the JAX kernel writes K3's point and
  normal inline), and ``chip_smoke.py`` holds the CUDA kernel against it on
  the card.
* ``record_iters > 0`` selects record mode (K2 / K3's record instance, the
  primal of the fused differentiable path, ``mega_diff.py``): per lane and
  loop iteration one int32 code ``tid*16 + checker_odd*8 + chain_end*4 +
  event`` (event 0 idle or metal absorption, 1 scatter, 2 light hit, 3 miss;
  ``tid`` the winner's texture id, ``n_textures`` for a dielectric scatter)
  and the throughput at the iteration's entry.  Row ``i`` of a lane is that
  lane's own ``i``-th loop iteration, which is the JAX kernel's block-level
  iteration ``i``: a lane steps once per block iteration from iteration 0
  until it is dead.  Rows past a lane's end are zero.  The JAX kernel writes
  the entry throughput on idle rows too, and may set the odd bit there; the
  replay ignores idle rows, and so do the comparisons.
* ``MEGA_FORWARD`` and ``enabled`` decide whether a forward render takes
  the megakernel (``ops/render.py``).
* ``walk_tallies`` and ``sweep_tallies`` launch the counting instances of
  K3's walk and of the sweep (CUDA only, measurements): the closest hit's
  tests, which equal the plain version's ``work`` totals, the active-lane
  share of the warp steps and the share of the launch spent in its tail.
* K1 takes its lanes by lane fetch (csrc/mega_kernel.cu): a persistent grid
  whose threads take the next lane as soon as theirs is spent; the outputs
  are those of one lane per thread (``prepare_launch(lane_fetch=False)``,
  the mapping of the other instances), bit for bit.

Geometry is pre-baked into world space per primitive row (``pack_rows``):
spheres as (c0, c1-c0, t0, 1/dt, r), rects as world parallelograms
(q0, eu, ev, n, d0 = n.q0, |eu|^2, |ev|^2), then shared material / texture
columns 16-26.  The sweep reads the geometry regrouped into 16-byte rows
(``pack_sweep_tables``), the material columns from the rows.  Accel rows
(``pack_accel_rows``) are the sphere tree's 16-column leaf rows (c0, c1-c0,
t0, 1/dt, r, code) widened by the same material columns, and the walk reads
``pack_accel_tables``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import bvh as bvh_ops
from another_raytracer_tpu_torch.ops import intersect, kernels, rng, vec3
from another_raytracer_tpu_torch.ops.kernels import bvh_kernel
from another_raytracer_tpu_torch.ops.vec3 import V3
from another_raytracer_tpu_torch.utils import profiling

BIG = 3e37
NEAR_ZERO_EPS = 1e-8  # vec3.h:51
# Columns per primitive row (flattened [N * ROW_W] f32).
ROW_W = 32
# Shared material slots (identical for both primitive kinds).
_C_MKIND, _C_FUZZ, _C_IR, _C_TKIND = 16, 17, 18, 19
_C_CA, _C_CB = 20, 23
_C_TID = 26  # texture id (exact in f32)
# Rows the kernel keeps in shared memory (64 x 32 f32 = 8 KB).
MAX_ROWS = 64
# Threads per CUDA block, by instance, as measured (chip_smoke.py times K1
# and K3 at 64-512, PERF.md).  K3 and its record instance: 128 beat 64, 256,
# 384 and 512 on the scene-1 README render and at the bench size, and the
# record instances keep it.  K1 with lane fetch: 384 (two blocks of 62
# registers per SM) beat 64-256 and 512 on the Cornell README render.
DEFAULT_BLOCK = 128
K1_BLOCK = 384

# Bits of the kernel's ``flags`` argument (csrc/mega_kernel.cu, enum Flags).
_HAS_LENS, _HAS_TIME, _HAS_METAL, _HAS_DIEL, _HAS_LIGHT, _HAS_CHECKER = (
    1, 2, 4, 8, 16, 32)


def _shading_ok(scene) -> bool:
    return (
        scene.n_media == 0
        and scene.n_triangles == 0
        and set(scene.mat_kinds) <= {
            scene_lib.MAT_LAMBERTIAN, scene_lib.MAT_METAL,
            scene_lib.MAT_DIELECTRIC, scene_lib.MAT_DIFFUSE_LIGHT}
        and set(scene.tex_kinds) <= {scene_lib.TEX_SOLID,
                                     scene_lib.TEX_CHECKER}
    )


def supports(scene, cam) -> bool:
    """Static applicability check, sweep mode (mega_kernel.py:97-103)."""
    return (
        not scene.has_accel
        and 0 < (scene.n_spheres + scene.n_rects) <= MAX_ROWS
        and _shading_ok(scene)
    )


# Leaf rows of the accel mode's sphere tree (mega_kernel.py:107 there; the
# TPU's VMEM budget, kept so both packages accept the same scenes: here at
# most ~393 KB of compact tables, read from device memory above MAX_SMEM).
ACCEL_MAX_ROWS = 8192
# The accel walk's compact tables: a node is 2 float4, a sphere 3
# (pack_accel_tables).
NODE_BYTES, SPHERE_BYTES = 32, 48
# Shared memory one block may take on the H100 after opting in (227 KB).
MAX_SMEM = 232448


def supports_accel(scene, cam) -> bool:
    """Static applicability check, accel mode (mega_kernel.py:110-128): one
    sphere tree and nothing else to intersect."""
    return (
        scene.sph_in_bvh
        and scene.n_sph_bvh_nodes > 0
        and scene.n_bvh_nodes == 0
        and scene.n_rect_bvh_nodes == 0
        and scene.n_rects == 0
        and scene.sph_bvh_rows.shape[0] <= ACCEL_MAX_ROWS
        and _shading_ok(scene)
    )


def accel_smem_bytes(scene) -> int:
    """Bytes of the accel walk's compact tables (``pack_accel_tables``)."""
    return (scene.n_sph_bvh_nodes * NODE_BYTES
            + scene.sph_bvh_rows.shape[0] * SPHERE_BYTES)


def accel_walk(scene) -> str:
    """Where K3's walk reads its tables: "shared" (each block copies them
    into shared memory) where they fit ``MAX_SMEM``, else "global" (device
    memory).  A choice by size; raises above ``ACCEL_MAX_ROWS``."""
    if scene.sph_bvh_rows.shape[0] > ACCEL_MAX_ROWS:
        raise ValueError(f"{scene.sph_bvh_rows.shape[0]} leaf rows: the "
                         f"accel mode takes at most {ACCEL_MAX_ROWS}")
    return "shared" if accel_smem_bytes(scene) <= MAX_SMEM else "global"


# None = auto (``enabled``), True forces the megakernel (raises on a scene
# it does not support), False sends every forward render to the wavefront.
MEGA_FORWARD = None


def enabled(scene, cam) -> bool:
    """Should a forward render of ``scene`` take the megakernel?

    The JAX package's semantics (mega_kernel.py:131-140) except for the auto
    rule.  JAX's auto takes sweep scenes only: on the TPU the accel mode
    measured neutral against its wavefront with the packet BVH kernel.  On
    the H100 the port's wavefront is host-bound (hundreds of small ops per
    loop iteration, PERF.md), and K3 runs the whole loop in one launch: the
    scene-1 README render (720x540, spp 100, depth 50) took 162 ms through
    K3 and 33,197 ms through the wavefront + K5 (chip_smoke.py's gate phase,
    H100 80GB HBM3 at 700 W), so auto takes accel scenes too.  The rule is
    the same on every device; CPU tensors run the plain versions.
    """
    if MEGA_FORWARD is False:
        return False
    ok = supports(scene, cam) or supports_accel(scene, cam)
    if MEGA_FORWARD is True and not ok:
        raise ValueError("MEGA_FORWARD forced on but scene unsupported")
    return ok


# --------------------------------------------------------------------------
# Row and camera packing
# --------------------------------------------------------------------------


def _onehot3(axis):
    """[N] int axis -> [N,3] f32 one-hot (exact 0/1)."""
    return (axis[:, None] == torch.arange(3, device=axis.device)).to(torch.float32)


def _mat_cols(scene, mat_ids):
    """Per-primitive baked material/texture scalars -> [N, 16] (cols 16..31)."""
    mat_ids = mat_ids.long()
    tex = scene.mat_tex[mat_ids].long()
    cols = [scene.mat_kind[mat_ids].to(torch.float32)[:, None],
            scene.mat_fuzz[mat_ids][:, None], scene.mat_ir[mat_ids][:, None],
            scene.tex_kind[tex].to(torch.float32)[:, None],
            scene.tex_ca[tex], scene.tex_cb[tex],
            tex.to(torch.float32)[:, None]]
    pad = torch.zeros((mat_ids.shape[0], ROW_W - _C_TID - 1),
                      dtype=torch.float32, device=mat_ids.device)
    return torch.cat(cols + [pad], dim=1)


def _matvec(rot, v):
    """[N,3,3] x [N,3] -> [N,3]."""
    return torch.einsum("nij,nj->ni", rot, v)


def pack_rows(scene):
    """[(Ns+Nr) * ROW_W] flat f32 row table; spheres first, then rects — the
    fold order of intersect.closest_hit (strict improvement keeps the
    earlier row on ties, like argmin's first-min-index)."""
    parts = []
    dev = scene.device
    if scene.n_spheres:
        xf = scene.sph_xf.long()
        rot, tr = scene.xf_rot[xf], scene.xf_trans[xf]
        c0w = _matvec(rot, scene.sph_c0) + tr
        c1w = _matvec(rot, scene.sph_c1) + tr
        dt = scene.sph_t1 - scene.sph_t0
        nz = dt != 0.0
        inv_dt = torch.where(nz, 1.0 / torch.where(nz, dt, torch.ones_like(dt)),
                             torch.zeros_like(dt))
        n = scene.n_spheres
        geom = torch.cat(
            [torch.zeros((n, 1), device=dev), c0w, c1w - c0w,
             scene.sph_t0[:, None], inv_dt[:, None], scene.sph_r[:, None],
             torch.zeros((n, _C_MKIND - 10), device=dev)], dim=1)
        parts.append(torch.cat([geom, _mat_cols(scene, scene.sph_mat)], dim=1))
    if scene.n_rects:
        axis = scene.rect_axis.long()
        au = torch.where(axis == 0, 1, 0)
        av = torch.where(axis == 2, 1, 2)
        lo, hi = scene.rect_lo, scene.rect_hi
        q0_obj = (_onehot3(axis) * scene.rect_k[:, None]
                  + _onehot3(au) * lo[:, 0:1] + _onehot3(av) * lo[:, 1:2])
        eu_obj = _onehot3(au) * (hi[:, 0:1] - lo[:, 0:1])
        ev_obj = _onehot3(av) * (hi[:, 1:2] - lo[:, 1:2])
        xf = scene.rect_xf.long()
        rot, tr = scene.xf_rot[xf], scene.xf_trans[xf]
        q0 = _matvec(rot, q0_obj) + tr
        eu = _matvec(rot, eu_obj)
        ev = _matvec(rot, ev_obj)
        nw = _matvec(rot, _onehot3(axis))
        d0 = torch.sum(nw * q0, dim=1, keepdim=True)
        # Exact object-space edge lengths squared (rotation-free, so the
        # identity-transform case reproduces the sweep's bound arithmetic).
        l2u = ((hi[:, 0] - lo[:, 0]) ** 2)[:, None]
        l2v = ((hi[:, 1] - lo[:, 1]) ** 2)[:, None]
        geom = torch.cat([torch.zeros((scene.n_rects, 1), device=dev), q0, eu,
                          ev, nw, d0, l2u, l2v], dim=1)
        parts.append(torch.cat([geom, _mat_cols(scene, scene.rect_mat)], dim=1))
    return torch.cat(parts, dim=0).reshape(-1).contiguous()


def pack_sweep_tables(scene, rows=None):
    """The sweep's compact tables as one [3 Ns + 4 Nr, 4] f32 tensor (float4
    rows, 16-byte aligned): per sphere row of ``pack_rows`` (c0.xyz, r) |
    (c1 - c0, t0) | (1/dt, 0, 0, 0), then per rect row (n.xyz, n.q0) |
    (q0.xyz, |eu|^2) | (eu.xyz, |ev|^2) | (ev.xyz, 0).  The same values as
    the rows' geometry columns, regrouped; ``rows`` is ``pack_rows(scene)``
    where the caller has it."""
    if rows is None:
        rows = pack_rows(scene)
    rows = rows.reshape(-1, ROW_W)
    ns = scene.n_spheres
    s, q = rows[:ns], rows[ns:]
    zero = torch.zeros_like(rows[:, :3])
    sph4 = torch.stack([s[:, [1, 2, 3, 9]], s[:, [4, 5, 6, 7]],
                        torch.cat([s[:, 8:9], zero[:ns]], 1)], 1)
    rect4 = torch.stack([q[:, [10, 11, 12, 13]], q[:, [1, 2, 3, 14]],
                         q[:, [4, 5, 6, 15]],
                         torch.cat([q[:, 7:10], zero[ns:, :1]], 1)], 1)
    return torch.cat([sph4.reshape(-1, 4), rect4.reshape(-1, 4)]).contiguous()


def pack_accel_rows(scene):
    """[N+pad, ROW_W] f32 rows of the accel mode (mega_kernel.py:786-790):
    the sphere tree's 16-column leaf rows widened with the material columns
    of each row's sphere.  Column 9 holds sphere id * 4 + kind, so the id is
    recoverable for every leaf-ordered row; pad rows (r = 0, never hit) take
    sphere 0's materials."""
    rows16 = scene.sph_bvh_rows
    orig = torch.clamp(rows16[:, 9].to(torch.int64) // 4, 0, scene.n_spheres - 1)
    return torch.cat([rows16, _mat_cols(scene, scene.sph_mat[orig])],
                     dim=1).contiguous()


def pack_accel_tables(scene):
    """The accel walk's compact tables as one [2M + 3N, 4] f32 tensor (float4
    rows, 16-byte aligned): per node of ``scene.sph_bvh_nodes`` (lo.xyz,
    escape) | (hi.xyz, meta), then per leaf-order sphere row of
    ``scene.sph_bvh_rows`` (c0.xyz, r) | (c1 - c0, t0) | (1/dt, 0, 0, 0).
    The same values as the nodes and rows, regrouped: K5's sphere tables
    (``bvh_kernel.pack_tables``)."""
    return bvh_kernel.pack_tables(scene.sph_bvh_nodes, scene.sph_bvh_rows,
                                  "sphere")


def pack_camera(scene, cam):
    """The 24 camera constants (mega_kernel.py:794-799): origin,
    lower_left - origin, horizontal, vertical, u, v, (lens_radius, time0,
    time1 - time0), background — f32 on the host (one device-to-host copy)."""
    return torch.cat([
        cam.origin, cam.lower_left - cam.origin, cam.horizontal, cam.vertical,
        cam.u, cam.v,
        torch.stack([cam.lens_radius, cam.time0, cam.time1 - cam.time0]),
        scene.background.to(cam.origin.device),
    ]).to(device="cpu", dtype=torch.float32).contiguous()


def _flags(scene, cam) -> int:
    mk, tk = set(scene.mat_kinds), set(scene.tex_kinds)
    return ((_HAS_LENS if cam.has_lens else 0)
            | (_HAS_TIME if cam.has_time and scene.has_motion else 0)
            | (_HAS_METAL if scene_lib.MAT_METAL in mk else 0)
            | (_HAS_DIEL if scene_lib.MAT_DIELECTRIC in mk else 0)
            | (_HAS_LIGHT if scene_lib.MAT_DIFFUSE_LIGHT in mk else 0)
            | (_HAS_CHECKER if scene_lib.TEX_CHECKER in tk else 0))


# --------------------------------------------------------------------------
# Wrapper
# --------------------------------------------------------------------------


def _check_lanes(pixel_ids, sample_ids0, scene=None):
    if pixel_ids.dtype != torch.int64 or sample_ids0.dtype != torch.int64:
        raise TypeError("pixel_ids / sample_ids0 must be int64 tensors "
                        "holding uint32 values")
    if pixel_ids.dim() != 1 or pixel_ids.shape != sample_ids0.shape:
        raise ValueError("pixel_ids and sample_ids0 must be 1-D of one length")
    if pixel_ids.device != sample_ids0.device:
        raise ValueError("pixel_ids and sample_ids0 must be on one device")
    if scene is not None and scene.device != pixel_ids.device:
        raise ValueError(f"scene is on {scene.device}, lanes on "
                         f"{pixel_ids.device}")


def trace_regenerative_mega(scene, cam, pixel_ids, sample_ids0, seed, *,
                            width: int, height: int, sample_stride: int,
                            sample_end, spp_cap, max_depth: int, t_min: float,
                            block: int | None = None, record_iters: int = 0,
                            counts=None):
    """Drop-in counterpart of the JAX ``trace_regenerative_mega`` (same
    arguments and return contract) for scenes where ``supports()`` or
    ``supports_accel()`` holds; a scene with a sphere tree runs the accel
    mode (K3), as the JAX wrapper decides (mega_kernel.py:776 there).

    ``pixel_ids`` / ``sample_ids0`` are int64 [B] tensors of uint32 values;
    lanes whose first sample is >= min(sample_end, spp_cap) (for example
    0xFFFFFFFF) are born dead.  ``block`` is the CUDA block size (threads;
    default ``K1_BLOCK`` for K1, else ``DEFAULT_BLOCK``).
    Returns (radiance V3 of [B] per-lane sums, segments as an int64 scalar
    tensor); with ``record_iters`` > 0 also (codes int32 [record_iters, B],
    tprev V3 of [record_iters, B]) — see the module docstring.
    ``record_iters`` must bound every lane's loop iterations
    (``_check_record_iters``).  ``counts`` (a dict, forward renders of a
    scene with spheres): receives under ``"sphere_hits"`` the loop
    iterations whose closest hit is a sphere, an int64 scalar tensor
    counted on the device, as the wavefront gives it; a scene without
    spheres counts nothing.  CUDA tensors launch ``csrc/mega_kernel.cu``;
    CPU tensors run the plain version; any other device raises.
    """
    if not (supports(scene, cam) or supports_accel(scene, cam)):
        raise ValueError("trace_regenerative_mega: scene not supported "
                         "(see supports() and supports_accel())")
    _check_lanes(pixel_ids, sample_ids0, scene)
    kw = dict(width=width, height=height, sample_stride=sample_stride,
              sample_end=sample_end, spp_cap=spp_cap, max_depth=max_depth,
              t_min=t_min, record_iters=record_iters)
    if pixel_ids.device.type == "cpu":
        return trace_regenerative_mega_reference(
            scene, cam, pixel_ids, sample_ids0, seed, counts=counts, **kw)
    if pixel_ids.device.type != "cuda":
        raise ValueError(f"no megakernel for device {pixel_ids.device}")
    return _launch(scene, cam, pixel_ids, sample_ids0, seed, block=block,
                   hits=_sphere_hit_counter(scene, counts, record_iters,
                                            pixel_ids.device), **kw)


def _sphere_hit_counter(scene, counts, record_iters, device):
    """A forward render's sphere-hit counter (a 0-d int64 tensor on
    ``device``), put in ``counts`` under ``"sphere_hits"``; None where
    nothing is counted: no ``counts``, a record launch, or no sphere."""
    if counts is None or record_iters or not scene.n_spheres:
        return None
    counts["sphere_hits"] = torch.zeros((), dtype=torch.int64, device=device)
    return counts["sphere_hits"]


def _check_record_iters(record_iters, *, sample_end, spp_cap, sample_stride,
                        max_depth):
    """Raise unless ``record_iters`` is 0 or bounds every lane's loop
    iterations: at most ceil(min(sample_end, spp_cap) / sample_stride)
    samples per lane, each at most max(max_depth, 1) iterations."""
    if record_iters < 0:
        raise ValueError("record_iters must be >= 0")
    limit = min(int(sample_end), int(spp_cap), rng.MASK32)
    need = -(-limit // max(int(sample_stride), 1)) * max(int(max_depth), 1)
    if 0 < record_iters < need:
        raise ValueError(f"record_iters={record_iters} is below the {need} "
                         "loop iterations a lane may take")


def _u32_bits(x):
    """int64 tensor of uint32 values -> int32 tensor with the same bits."""
    x = x & rng.MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def _lib(build="forward"):
    """The forward build (K1 and K3's forward instance, threefry check), the
    record build (K2 and K3's record instance) or the counting build (the
    counting instances of the sweep and of K3's walk)."""
    from another_raytracer_tpu_torch.ops.kernels import _build

    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    args = [P, I, I, P, I, I, I, P, P, P, I, U, U, U, I, I, I, F, I, I,
            P, P, P, P]
    if build == "record":
        lib = _build.load("mega_kernel_record")
        lib.art_mega_record.argtypes = args + [I, I, P, P, P]
        lib.art_mega_record.restype = I
        return lib
    if build == "count":
        lib = _build.load("mega_kernel_count")
        lib.art_mega_count.argtypes = args + [P, I, P, P, P]
        lib.art_mega_count.restype = I
        return lib
    lib = _build.load("mega_kernel")
    lib.art_mega_forward.argtypes = args + [P, P, P]
    lib.art_mega_forward.restype = I
    lib.art_threefry_words.argtypes = [U, U, P, P, I, P, P, P, P, P]
    lib.art_threefry_words.restype = I
    return lib


# The counting instance's totals, in the order csrc/mega_kernel.cu adds
# them: K3's walk (slab tests, sphere tests, the active lanes of its slab and
# leaf warp steps, sphere tests in the ground's leaf), the sweep's rect row
# tests (its sphere row tests are ``sphere_tests``), the warp steps of the
# lane loop and their active lanes, and the most loop steps of one warp.
TALLIES = ("slab_tests", "sphere_tests", "slab_steps", "slab_active",
           "leaf_steps", "leaf_active", "ground_tests", "rect_tests",
           "loop_steps", "loop_active", "warp_loop_steps_max")


def _ground_node(scene) -> int:
    """The leaf node holding the sphere of largest |radius| (the ground)."""
    rows = scene.sph_bvh_rows
    row = int(torch.argmax(rows[:, 8].abs()))
    meta = scene.sph_bvh_nodes[:, 7].to(torch.int64)
    first, count = meta // bvh_ops.META_SCALE, meta % bvh_ops.META_SCALE
    leaf = ((count > 0) & (first <= row) & (row < first + count)).nonzero()
    return int(leaf[0, 0])


def launch_shape(scene, record_iters=0, lane_fetch=True, block=None):
    """(block size, lane fetch) of a launch: lane fetch only in the sweep's
    forward and counting instances (K1 runs a persistent grid whose threads
    take the next lane as soon as theirs is spent, csrc/mega_kernel.cu), and
    the block ``K1_BLOCK`` with lane fetch, else ``DEFAULT_BLOCK``, unless
    ``block`` is given."""
    fetch = bool(lane_fetch) and scene.n_sph_bvh_nodes == 0 and not record_iters
    if block is None:
        block = K1_BLOCK if fetch else DEFAULT_BLOCK
    return int(block), fetch


def prepare_launch(scene, cam, pixel_ids, sample_ids0, seed, *, width,
                   height, sample_stride, sample_end, spp_cap, max_depth,
                   t_min, block=None, record_iters=0, tally=False,
                   lane_fetch=True, sphere_hits=None):
    """Everything one CUDA launch needs, built on the lanes' device: returns
    (run, output tensors).  ``run()`` is the bare launch (it returns the
    CUDA error code); the wrapper adds the checks, the launch count and the
    segment sum.  ``tally`` selects the counting instance, whose outputs end
    in the u64 totals of ``TALLIES`` (as int64) and each block's start and
    end time ([blocks, 2] int64 ns, zero for blocks the grid did not hold).
    ``lane_fetch`` applies to the sweep's forward and counting instances: a
    persistent grid with lane fetch, or one lane per thread (as the other
    instances run); each lane's outputs are the same bits either way.  ``block``
    defaults to ``K1_BLOCK`` with lane fetch, else ``DEFAULT_BLOCK``.
    ``sphere_hits`` (forward instances only): a 0-d int64 tensor on the
    lanes' device that each run adds the launch's sphere hits into (the
    loop iterations whose closest hit is a sphere)."""
    dev = pixel_ids.device
    if sample_stride < 1:
        raise ValueError("sample_stride must be >= 1")
    _check_record_iters(record_iters, sample_end=sample_end, spp_cap=spp_cap,
                        sample_stride=sample_stride, max_depth=max_depth)
    if tally and record_iters:
        raise ValueError("tally counts a forward launch, without record_iters")
    if sphere_hits is not None and (tally or record_iters
                                    or sphere_hits.dtype != torch.int64
                                    or sphere_hits.device != dev):
        raise ValueError("sphere_hits is a 0-d int64 tensor on the lanes' "
                         "device, counted by the forward instances only")
    lib = _lib("count" if tally else "record" if record_iters else "forward")
    accel = scene.n_sph_bvh_nodes > 0
    with profiling.span("mega.prepare",
                        instance="K3" if accel else "K2" if record_iters
                        else "K1", lanes=pixel_ids.shape[0]):
        block, fetch = launch_shape(scene, record_iters, lane_fetch, block)
        if accel:
            # K3: the widened leaf rows (all of them, pad rows included:
            # the material columns) and the walk's compact tables, copied
            # into each block's shared memory where they fit.
            rows = pack_accel_rows(scene)
            tab = pack_accel_tables(scene)
            smem = (accel_smem_bytes(scene)
                    if accel_walk(scene) == "shared" else 0)
            geometry = (rows, rows.shape[0], 0, tab, scene.n_sph_bvh_nodes,
                        scene.bvh_leaf_size, smem)
        else:
            # The sweep: its compact tables (copied into each block's shared
            # memory) and the rows, read for the winner's material columns.
            rows = pack_rows(scene)
            geometry = (rows, scene.n_spheres, scene.n_rects,
                        pack_sweep_tables(scene, rows), 0, 0, 0)
        camc = pack_camera(scene, cam)
        limit = min(int(sample_end), int(spp_cap), rng.MASK32)
        pix = _u32_bits(pixel_ids)
        samp = _u32_bits(sample_ids0)
        B = pixel_ids.shape[0]
        if record_iters * B >= 2**31:
            raise ValueError("record_iters * lanes must stay below 2**31")
        out = [torch.empty(B, dtype=torch.float32, device=dev)
               for _ in range(3)]
        seg = torch.empty(B, dtype=torch.int32, device=dev)
        args = (*geometry, camc, pix, samp, B,
                int(seed) & rng.MASK32, limit, int(sample_stride), int(width),
                int(height), int(max_depth), float(t_min), _flags(scene, cam),
                int(block), *out, seg)
        # The launch zeroes the counter itself.
        counter = (torch.empty(1, dtype=torch.int32, device=dev) if fetch
                   else None)
        if record_iters:
            # The kernel writes every residual element (rows past a lane's
            # end as zeros), so the buffers need no clearing.
            codes = torch.empty((record_iters, B), dtype=torch.int32,
                                device=dev)
            tprev = torch.empty((3, record_iters, B), dtype=torch.float32,
                                device=dev)
            entry = lib.art_mega_record
            args += (int(record_iters), scene.tex_kind.shape[0], codes, tprev)
            outputs = (out, seg, codes, tprev)
        elif tally:
            totals = torch.zeros(len(TALLIES), dtype=torch.int64, device=dev)
            times = torch.zeros((-(-B // int(block)), 2), dtype=torch.int64,
                                device=dev)
            entry = lib.art_mega_count
            args += (counter, _ground_node(scene) if accel else -1, totals,
                     times)
            outputs = (out, seg, totals, times)
        else:
            entry = lib.art_mega_forward
            args += (counter, sphere_hits)
            outputs = (out, seg)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                     for a in args) + (stream,)

    def run(_inputs=args):  # the default keeps the tensors behind ptrs alive
        return entry(*ptrs)

    return run, outputs


def _launch(scene, cam, pixel_ids, sample_ids0, seed, *, block, record_iters,
            hits, **kw):
    run, outputs = prepare_launch(
        scene, cam, pixel_ids, sample_ids0, seed, block=block,
        record_iters=record_iters, sphere_hits=hits, **kw)
    with torch.cuda.device(pixel_ids.device), profiling.span("mega.launch"):
        err = run()
    if err != 0:
        raise RuntimeError(f"mega_kernel launch failed: CUDA error {err}")
    out, seg = outputs[:2]
    total, segments = V3(*out), seg.sum(dtype=torch.int64)
    if pixel_ids.shape[0]:
        # K1 / K2 the sweep's forward and record instances, K3 / K3_record
        # the accel mode's, K3*_global on tables in device memory.
        if scene.n_sph_bvh_nodes > 0:
            name = ("K3" + ("_record" if record_iters else "")
                    + ("_global" if accel_walk(scene) == "global" else ""))
        else:
            name = "K2" if record_iters else "K1"
        kernels.count(name)
    if record_iters:
        return total, segments, outputs[2], V3(*outputs[3].unbind(0))
    return total, segments


def tail_share(times):
    """The share of the SM-slot time a launch spent in its tail, from each
    block's start and end (``prepare_launch``'s ``times``, ns): a block that
    ends after the last block started is the last on its slot, so its slot
    is idle from its end to the launch's end.  Returns (tail share, slots,
    launch ms on the device clock) with tail share = sum of those idle
    times / (slots x launch time)."""
    t = times[times[:, 0] > 0].to(torch.float64)
    start, end = t[:, 0], t[:, 1]
    t0, t1 = float(start.min()), float(end.max())
    last = end >= float(start.max())
    idle = float((t1 - end[last]).sum())
    slots = int(last.sum())
    return idle / max(slots * (t1 - t0), 1.0), slots, (t1 - t0) / 1e6


def _tallies(scene, cam, pixel_ids, sample_ids0, seed, *, block, lane_fetch,
             **kw):
    """One counting launch: (radiance V3, segments, {tally: int}) with the
    ``TALLIES``, the loop's active-lane share ``loop_simt`` (active lanes /
    (32 x warp steps)), the ``blocks`` that ran and the launch's
    ``tail_share``, ``slots`` and ``launch_ms`` (``tail_share``)."""
    if pixel_ids.device.type != "cuda":
        raise ValueError("the counting instance needs CUDA tensors")
    _check_lanes(pixel_ids, sample_ids0, scene)
    run, (out, seg, totals, times) = prepare_launch(
        scene, cam, pixel_ids, sample_ids0, seed, block=block, tally=True,
        lane_fetch=lane_fetch, **kw)
    with torch.cuda.device(pixel_ids.device):
        err = run()
    if err != 0:
        raise RuntimeError(f"mega_kernel count launch failed: CUDA error {err}")
    t = dict(zip(TALLIES, totals.tolist()))
    t["block"] = launch_shape(scene, 0, lane_fetch, block)[0]
    t["loop_simt"] = t["loop_active"] / max(32 * t["loop_steps"], 1)
    times = times.cpu()
    t["blocks"] = int((times[:, 0] > 0).sum())
    t["tail_share"], t["slots"], t["launch_ms"] = tail_share(times)
    return V3(*out), seg.sum(dtype=torch.int64), t


def walk_tallies(scene, cam, pixel_ids, sample_ids0, seed, *, width, height,
                 sample_stride, sample_end, spp_cap, max_depth, t_min,
                 block=None):
    """K3's counting instance on CUDA lanes (a measurement; the render paths
    never launch it): the forward render with the record build's arithmetic,
    so its paths, radiance and walk are the plain version's.  Returns
    (radiance V3, segments, {tally: value}) with ``_tallies``' entries and
    the walk's active-lane shares ``slab_simt`` and ``leaf_simt`` (active
    lanes / (32 x warp steps)) and ``ground_share`` (the ground leaf's share
    of the sphere tests)."""
    if not supports_accel(scene, cam):
        raise ValueError("walk_tallies counts the accel mode's walk")
    rad, segs, t = _tallies(
        scene, cam, pixel_ids, sample_ids0, seed, width=width, height=height,
        sample_stride=sample_stride, sample_end=sample_end, spp_cap=spp_cap,
        max_depth=max_depth, t_min=t_min, block=block, lane_fetch=False)
    t.update(slab_simt=t["slab_active"] / max(32 * t["slab_steps"], 1),
             leaf_simt=t["leaf_active"] / max(32 * t["leaf_steps"], 1),
             ground_share=t["ground_tests"] / max(t["sphere_tests"], 1))
    return rad, segs, t


def sweep_tallies(scene, cam, pixel_ids, sample_ids0, seed, *, width, height,
                  sample_stride, sample_end, spp_cap, max_depth, t_min,
                  block=None, lane_fetch=True):
    """The sweep's counting instance on CUDA lanes (a measurement; the render
    paths never launch it): K1's launch (``lane_fetch`` as in
    ``prepare_launch``; without it, K2's lane mapping) with the record
    build's arithmetic, so its paths and radiance are the plain version's,
    and its sphere and rect row tests equal the plain version's ``work``.
    Returns (radiance V3, segments, {tally: value}) with ``_tallies``'
    entries and ``rows_per_segment``."""
    if not supports(scene, cam):
        raise ValueError("sweep_tallies counts the sweep")
    rad, segs, t = _tallies(
        scene, cam, pixel_ids, sample_ids0, seed, width=width, height=height,
        sample_stride=sample_stride, sample_end=sample_end, spp_cap=spp_cap,
        max_depth=max_depth, t_min=t_min, block=block, lane_fetch=lane_fetch)
    t["rows_per_segment"] = ((t["sphere_tests"] + t["rect_tests"])
                             / max(int(segs), 1))
    return rad, segs, t


def threefry_words_cuda(seed: int, key1: int, pixel, sample):
    """The CUDA kernel's own 13-round threefry words and uniforms for key
    (seed, key1) and counters (pixel, sample) — int64 [B] CUDA tensors of
    uint32 values.  Returns (w0, w1) as int64 and (u0, u1) as float32."""
    if pixel.device.type != "cuda":
        raise ValueError("threefry_words_cuda needs CUDA tensors")
    _check_lanes(pixel, sample)
    lib = _lib()
    B = pixel.shape[0]
    dev = pixel.device
    px, sm = _u32_bits(pixel), _u32_bits(sample)
    w = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2)]
    u = [torch.empty(B, dtype=torch.float32, device=dev) for _ in range(2)]
    with torch.cuda.device(dev):
        err = lib.art_threefry_words(
            int(seed) & rng.MASK32, int(key1) & rng.MASK32, px.data_ptr(),
            sm.data_ptr(), B, w[0].data_ptr(), w[1].data_ptr(),
            u[0].data_ptr(), u[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    return tuple(x.to(torch.int64) & rng.MASK32 for x in w), tuple(u)


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------


def trace_regenerative_mega_reference(scene, cam, pixel_ids, sample_ids0, seed,
                                      *, width: int, height: int,
                                      sample_stride: int, sample_end, spp_cap,
                                      max_depth: int, t_min: float,
                                      record_iters: int = 0,
                                      work: bool = False, counts=None):
    """The kernel's per-lane algorithm as tensor ops on [B] lanes (any
    device).  Every lane steps once per loop iteration while any lane is
    alive; a dead lane changes nothing, so each lane's result equals the
    kernel's own per-lane loop, and loop iteration ``it`` is every alive
    lane's own ``it``-th iteration (the record row).  Same return contract
    as the wrapper; with ``work`` the result also ends in the closest hit's
    totals, the work the kernel does on these inputs, which its counting
    instance must equal: in accel mode the walk's (slab tests, sphere tests)
    (``walk_tallies``), in sweep mode the (sphere row tests, rect row tests)
    of every alive lane's every loop iteration (``sweep_tallies``).
    ``counts`` as the wrapper's: the alive lanes' loop iterations whose
    closest hit is a sphere, counted as the forward instances count them."""
    _check_lanes(pixel_ids, sample_ids0, scene)
    _check_record_iters(record_iters, sample_end=sample_end, spp_cap=spp_cap,
                        sample_stride=sample_stride, max_depth=max_depth)
    if not (supports(scene, cam) or supports_accel(scene, cam)):
        raise ValueError("trace_regenerative_mega_reference: scene not "
                         "supported (see supports() and supports_accel())")
    accel = scene.n_sph_bvh_nodes > 0
    f32 = np.float32
    if accel:
        rows = pack_accel_rows(scene)
        # The walk reads the geometry columns and the code (0-9) only.
        walk_rows = rows[:, :10].contiguous()
        # Leaf row of each sphere: the walk reports the winner's code
        # (sphere id * 4 + kind, column 9); pad rows are never hit.
        row_of = torch.empty(scene.n_spheres, dtype=torch.int64,
                             device=rows.device)
        row_of[rows[:scene.n_spheres, 9].to(torch.int64) // 4] = torch.arange(
            scene.n_spheres, device=rows.device)
    else:
        rows = pack_rows(scene)
        tab = pack_sweep_tables(scene, rows)
        rows = rows.reshape(-1, ROW_W)
    ns = scene.n_spheres
    camc = [float(v) for v in pack_camera(scene, cam).tolist()]
    cam_o, cam_base, cam_h, cam_v, cam_u, cam_w = (
        camc[k:k + 3] for k in range(0, 18, 3))
    lens_radius, time0, time_del = camc[18:21]
    bg = camc[21:24]
    flags = _flags(scene, cam)
    has_metal, has_diel = bool(flags & _HAS_METAL), bool(flags & _HAS_DIEL)
    has_light, has_checker = bool(flags & _HAS_LIGHT), bool(flags & _HAS_CHECKER)
    need_unit_d = has_metal or has_diel
    seed = int(seed) & rng.MASK32
    limit = min(int(sample_end), int(spp_cap), rng.MASK32)
    stride = int(sample_stride)
    # f32 constants exactly as the kernel forms them.
    inv_w1 = float(f32(1.0 / (width - 1)))
    inv_h1 = float(f32(1.0 / (height - 1)))
    h1 = float(height - 1)
    t_min = float(f32(t_min))

    pix = pixel_ids & rng.MASK32
    fi = (pix % width).to(torch.float32)
    fj = (pix // width).to(torch.float32)

    def cam_rays(sample):
        ju, jv = rng.uniform2(seed, pix, sample, rng.CAMERA_BOUNCE,
                              rng.DIM_PIXEL_JITTER)
        s = (fi + ju) * inv_w1
        t = (h1 - fj + jv) * inv_h1
        if flags & _HAS_LENS:
            lu, lv = rng.uniform2(seed, pix, sample, rng.CAMERA_BOUNCE,
                                  rng.DIM_LENS)
            rdx, rdy = vec3.in_unit_disk_from_uniforms(lu, lv)
            rdx, rdy = lens_radius * rdx, lens_radius * rdy
            offs = [cam_u[c] * rdx + cam_w[c] * rdy for c in range(3)]
            o = V3(*(offs[c] + cam_o[c] for c in range(3)))
            d = V3(*(cam_base[c] + cam_h[c] * s + cam_v[c] * t - offs[c]
                     for c in range(3)))
        else:
            o = V3(*(torch.full_like(s, cam_o[c]) for c in range(3)))
            d = V3(*(cam_base[c] + cam_h[c] * s + cam_v[c] * t
                     for c in range(3)))
        if flags & _HAS_TIME:
            tu, _ = rng.uniform2(seed, pix, sample, rng.CAMERA_BOUNCE,
                                 rng.DIM_TIME)
            tm = time0 + tu * time_del
        else:
            tm = torch.full_like(s, time0)
        return o, d, tm

    sample = sample_ids0 & rng.MASK32
    o, d, tm = cam_rays(sample)
    alive = sample < limit
    zero = torch.zeros_like(fi)
    zeros3 = V3(zero, zero, zero)
    ones3 = V3(zero + 1.0, zero + 1.0, zero + 1.0)
    tp, path, acc = ones3, zeros3, zeros3
    bounce = torch.zeros_like(sample)
    seg = alive.to(torch.int64)
    B = fi.shape[0]
    codes = torch.zeros((record_iters, B), dtype=torch.int32, device=fi.device)
    tprev = torch.zeros((3, record_iters, B), dtype=torch.float32,
                        device=fi.device)
    n_textures = scene.tex_kind.shape[0]
    it = 0
    walked = [0, 0]
    sphere_hits = _sphere_hit_counter(scene, counts, record_iters, fi.device)

    while bool(alive.any()):
        a_len = vec3.dot(d, d)
        if accel:
            best_t, r, b_n, p = _accel_hit(scene, rows, walk_rows, row_of, o,
                                           d, tm, alive, t_min, walked)
            is_sph = True
        else:
            best_t, best, b_n, p = _sweep(tab, ns, o, d, tm, a_len, t_min)
            r = rows[best]
            is_sph = best < ns
            if work:
                n_alive = int(alive.sum())
                walked[0] += ns * n_alive
                walked[1] += scene.n_rects * n_alive
        hit = alive & (best_t < BIG)
        miss_now = alive & ~hit
        tp_entry = tp
        if sphere_hits is not None:
            sphere_hits.add_((hit & is_sph).sum())

        # ---- shade + scatter (shade.emit_and_scatter) ---------------------
        front = vec3.dot(b_n, d) < 0.0
        n = vec3.where(front, b_n, -b_n)
        mk = r[:, _C_MKIND]
        alb = V3.from_array(r[:, _C_CA:_C_CA + 3])
        if has_checker:
            sines = (vec3.sin(10.0 * p.x) * vec3.sin(10.0 * p.y)
                     * vec3.sin(10.0 * p.z))
            is_check = (hit & (r[:, _C_TKIND] == scene_lib.TEX_CHECKER)
                        & (sines < 0.0))
            alb = vec3.where(is_check, V3.from_array(r[:, _C_CB:_C_CB + 3]), alb)

        u1, u2 = rng.uniform2(seed, pix, sample, bounce, rng.DIM_SCATTER_A)
        rand_unit = vec3.unit_vector_from_uniforms(u1, u2)
        if has_metal or has_diel:
            u3, u4 = rng.uniform2(seed, pix, sample, bounce, rng.DIM_SCATTER_B)
        if need_unit_d:
            inv_len = 1.0 / vec3.sqrt(torch.where(a_len > 0.0, a_len,
                                              torch.ones_like(a_len)))
            unit_d = d * inv_len

        # lambertian (material.h:29-36)
        lam = n + rand_unit
        lam_nz = ((lam.x.abs() < NEAR_ZERO_EPS) & (lam.y.abs() < NEAR_ZERO_EPS)
                  & (lam.z.abs() < NEAR_ZERO_EPS))
        new_d = vec3.where(lam_nz, n, lam)
        ok = hit
        if has_metal:
            is_met = mk == scene_lib.MAT_METAL
            cr = torch.where(
                u3 > 0.0,
                torch.exp(torch.log(torch.clamp_min(u3, 1e-38)) * float(f32(1 / 3))),
                zero)
            uddn = vec3.dot(unit_d, n)
            met = unit_d - n * (2.0 * uddn) + (rand_unit * cr) * r[:, _C_FUZZ]
            met_ok = vec3.dot(met, n) > 0.0
            new_d = vec3.where(is_met, met, new_d)
            ok = (ok & ~is_met) | (is_met & hit & met_ok)
        if has_diel:
            is_die = mk == scene_lib.MAT_DIELECTRIC
            ir = r[:, _C_IR]
            ratio = torch.where(front, 1.0 / ir, ir)
            uddn = vec3.dot(unit_d, n)
            cos_t = torch.clamp_max(-uddn, 1.0)
            sin_t = vec3.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
            cannot = ratio * sin_t > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            x = 1.0 - cos_t
            refl = r0 + (1.0 - r0) * (x * ((x * x) * (x * x)))
            rfl = unit_d - n * (2.0 * uddn)
            perp = (unit_d + n * cos_t) * ratio
            par = -vec3.sqrt(torch.clamp_min((1.0 - vec3.dot(perp, perp)).abs(),
                                              1e-12))
            rfr = perp + n * par
            die = vec3.where(cannot | (refl > u4), rfl, rfr)
            new_d = vec3.where(is_die, die, new_d)

        att = alb
        if has_diel:
            att = vec3.where(is_die, ones3, att)
        delta = vec3.where(miss_now, tp * V3(*bg), zeros3)
        if has_light:
            is_light = mk == scene_lib.MAT_DIFFUSE_LIGHT
            ok = ok & ~is_light
            delta = delta + vec3.where(hit & is_light, tp * alb, zeros3)

        # ---- radiance / carry updates (integrator._advance + regen body) --
        scattered = hit & ok
        path = path + delta
        tp = vec3.where(scattered, tp * att, tp)
        o = vec3.where(scattered, p, o)
        d = vec3.where(scattered, new_d, d)
        bounce = torch.where(alive, bounce + 1, bounce)
        alive_next = scattered & (bounce < max_depth)
        seg = seg + scattered.to(torch.int64)

        ended = alive & ~alive_next
        if record_iters:
            # Residual row (mega_kernel.py:691-723 there): the event, the
            # winner's texture id (the sentinel n_textures for a dielectric,
            # whose attenuation is 1), the checker cell and the chain end.
            ev = scattered.to(torch.int32) + 3 * miss_now.to(torch.int32)
            tid = torch.where(hit, r[:, _C_TID].to(torch.int32), 0)
            if has_light:
                ev = ev + 2 * (hit & is_light).to(torch.int32)
            if has_diel:
                tid = torch.where(hit & is_die, n_textures, tid)
            code = torch.where(ev > 0, tid * 16, 0) + 4 * ended.to(torch.int32) + ev
            if has_checker:
                code = code + 8 * is_check.to(torch.int32)
            codes[it] = torch.where(alive, code, 0)
            for c in range(3):
                tprev[c, it] = torch.where(alive, tp_entry[c], 0.0)
        it += 1
        acc = vec3.where(ended, acc + path, acc)
        path = vec3.where(ended, zeros3, path)
        sample = torch.where(ended, (sample + stride) & rng.MASK32, sample)
        regen = ended & (sample < limit)
        if bool(regen.any()):
            o2, d2, tm2 = cam_rays(sample)
            o = vec3.where(regen, o2, o)
            d = vec3.where(regen, d2, d)
            tm = torch.where(regen, tm2, tm)
            tp = vec3.where(regen, ones3, tp)
            bounce = torch.where(regen, 0, bounce)
        alive = alive_next | regen
        seg = seg + regen.to(torch.int64)
    out = (acc, seg.sum())
    if record_iters:
        out = out + (codes, V3(*tprev.unbind(0)))
    return out + (tuple(walked),) if work else out


def _accel_hit(scene, rows, walk_rows, row_of, o: V3, d: V3, tm, alive,
               t_min, walked):
    """K3's closest hit for the alive lanes: the stackless walk of the
    sphere tree (``ops.bvh.traverse_packed``, the plain version of K5, whose
    sphere test and strict-``<`` leaf fold are K3's), then the winner
    re-projected onto its sphere (``_onto_winner``, with K3's 1/r,
    mega_kernel.py:462-465 there).  Returns (best_t, the winner's widened
    row, normal, hit point), as ``_sweep``; adds the walk's slab and sphere
    tests to ``walked``."""
    B = o.x.shape[0]
    dev = o.x.device
    best_t = torch.full((B,), BIG, dtype=torch.float32, device=dev)
    best = torch.zeros(B, dtype=torch.int64, device=dev)
    lanes = alive.nonzero().squeeze(1)
    n = lanes.numel()
    if n:
        sel = lambda v: V3(*(c[lanes] for c in v))  # noqa: E731
        t, code, improved, slabs, tests = bvh_ops.traverse_packed(
            scene.sph_bvh_nodes, walk_rows, sel(o), sel(d), tm[lanes], t_min,
            torch.full((n,), BIG, dtype=torch.float32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            leaf_size=scene.bvh_leaf_size, prim="sphere", counts=True)
        best_t[lanes] = t
        best[lanes] = torch.where(improved, row_of[code.to(torch.int64) // 4],
                                  0)
        walked[0] += int(slabs.sum())
        walked[1] += int(tests.sum())
    r = rows[best]
    frac = (tm - r[:, 6]) * r[:, 7]
    rad = r[:, 8]
    inv_r = 1.0 / torch.where(rad != 0.0, rad, torch.ones_like(rad))
    center = V3(*(r[:, c] + frac * r[:, 3 + c] for c in range(3)))
    return (best_t, r) + _onto_winner(o, d, best_t, center, rad, inv_r)


def _onto_winner(o: V3, d: V3, t, center: V3, rad, inv_r):
    """(normal, hit point) of sphere winners hit at ``t``: the offset of
    ``o + d t`` from the centre re-projected onto the sphere
    (``intersect._onto_sphere``, the rule's one definition), the normal
    ``on * inv_r`` and the point ``(o + d t) + (on - off)``, intersect's
    form, which is ``o + d t`` itself wherever ``on`` is ``off``."""
    p = o + d * t
    off = p - center
    on = intersect._onto_sphere(off, rad)
    return on * inv_r, p + (on - off)


def _sweep(tab, ns, o: V3, d: V3, tm, a_len, t_min):
    """Closest hit over all rows of the sweep's tables (``pack_sweep_tables``)
    as [B, N] tensor ops.  Each row's candidate t is the kernel's; the
    winner is the first row attaining the minimum, which is what the
    kernel's sequential strict-`<` fold keeps.  Returns (best_t [B] with BIG
    on a miss, the winner's row index [B] (row 0 on a miss: read only where
    there is a hit), hit normal V3, hit point V3)."""
    cands = []
    inf = float("inf")
    s = tab[:3 * ns].reshape(ns, 3, 4)
    q = tab[3 * ns:].reshape(-1, 4, 4)
    if ns:
        inv_a = (1.0 / torch.where(a_len > 0.0, a_len,
                                   torch.ones_like(a_len)))[:, None]
        c0, dc, rad = s[:, 0, :3], s[:, 1, :3], s[:, 0, 3]
        frac = (tm[:, None] - s[:, 1, 3]) * s[:, 2, 0]
        cx = c0[:, 0] + frac * dc[:, 0]
        cy = c0[:, 1] + frac * dc[:, 1]
        cz = c0[:, 2] + frac * dc[:, 2]
        ocx, ocy, ocz = o.x[:, None] - cx, o.y[:, None] - cy, o.z[:, None] - cz
        half_b = ocx * d.x[:, None] + ocy * d.y[:, None] + ocz * d.z[:, None]
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = half_b * half_b - a_len[:, None] * c
        ok = disc > 0.0
        sq = vec3.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
        root1 = (-half_b - sq) * inv_a
        t = torch.where(root1 > t_min, root1, (-half_b + sq) * inv_a)
        valid = ok & (t > t_min) & (t < BIG)
        cands.append(torch.where(valid, t, inf))
    if q.shape[0]:
        nrm, q0, eu, ev = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        ndotd = d.x[:, None] * nrm[:, 0] + d.y[:, None] * nrm[:, 1] + d.z[:, None] * nrm[:, 2]
        ndoto = o.x[:, None] * nrm[:, 0] + o.y[:, None] * nrm[:, 1] + o.z[:, None] * nrm[:, 2]
        ok = ndotd != 0.0
        t = (nrm[:, 3] - ndoto) / torch.where(ok, ndotd, torch.ones_like(ndotd))
        rx = o.x[:, None] + t * d.x[:, None] - q0[:, 0]
        ry = o.y[:, None] + t * d.y[:, None] - q0[:, 1]
        rz = o.z[:, None] + t * d.z[:, None] - q0[:, 2]
        a = rx * eu[:, 0] + ry * eu[:, 1] + rz * eu[:, 2]
        b = rx * ev[:, 0] + ry * ev[:, 1] + rz * ev[:, 2]
        inside = (a >= 0.0) & (a <= q0[:, 3]) & (b >= 0.0) & (b <= eu[:, 3])
        valid = ok & inside & (t > t_min) & (t < BIG)
        cands.append(torch.where(valid, t, inf))
    t_all = torch.cat(cands, dim=1)
    best_t, best = torch.min(t_all, dim=1)
    best_t = torch.where(best_t < BIG, best_t, torch.full_like(best_t, BIG))

    # The winner's normal and point: a rect's n at o + t d; a sphere's
    # re-projected from its centre at tm.
    is_sph = best < ns
    rq = q[torch.clamp(best - ns, min=0)] if q.shape[0] else None
    b_n = (V3.from_array(rq[:, 0, :3]) if rq is not None
           else V3(*(torch.zeros_like(best_t) for _ in range(3))))
    p = o + d * best_t
    if ns:
        w = s[torch.clamp(best, max=ns - 1)]
        frac = (tm - w[:, 1, 3]) * w[:, 2, 0]
        center = V3(w[:, 0, 0] + frac * w[:, 1, 0], w[:, 0, 1] + frac * w[:, 1, 1],
                    w[:, 0, 2] + frac * w[:, 1, 2])
        n_sph, p_sph = _onto_winner(o, d, best_t, center, w[:, 0, 3],
                                    1.0 / w[:, 0, 3])
        b_n = vec3.where(is_sph, n_sph, b_n)
        p = vec3.where(is_sph, p_sph, p)
    return best_t, best, b_n, p
