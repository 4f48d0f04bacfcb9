"""Fused differentiable path: record-mode megakernel primal + replay backward
(port of ``another_raytracer_tpu.ops.pallas.mega_diff``).

For the megakernel's scenes (sweep scenes, and scenes whose spheres sit in
one BVH: ``mega_kernel.supports`` / ``supports_accel``) with lambertian /
metal / dielectric / diffuse-light materials and solid / checker textures, a
lane's radiance is an explicit multiplicative chain,

    L_lane = sum_chains sum_k (prod_{j<k} a_j) x_k,

x_k a light's texture or the background, so its complete gradient with
respect to the shading parameters is a function of the per-iteration winner
texture ids and events plus the current parameter values.  The forward runs
the megakernel in record mode (K2, or K3's record instance on a sphere tree:
``mega_kernel.trace_regenerative_mega`` with ``record_iters``), which writes
one code row and the entry throughput per loop iteration; the backward is a
reverse replay over those rows
(``replay_backward``: the CUDA kernel ``csrc/mega_replay.cu`` on CUDA
tensors, ``replay_backward_reference`` on CPU tensors).  No sweep, no
hit-record recompute and no shading math in the backward.

Gradient scope: d/d tex_ca, d/d tex_cb and d/d background are exact; tex_cc,
mat_fuzz, mat_ir and atlas do not reach the radiance value of this scene
class (fuzz and ir steer only directions, and the textures are piecewise
constant), so their gradient is zero, which the backward returns.
Geometry leaves are refused by ``enabled()``.
"""

from __future__ import annotations

import ctypes

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops.kernels import mega_kernel
from another_raytracer_tpu_torch.ops.vec3 import V3

# None = auto (supports_diff and a declared, geometry-free trainable set),
# False = off (the lockstep autograd path), True = force (raises where the
# fused path cannot give the gradients asked for).
FUSED_DIFF = None

# Residual rows per lane.  The TPU bound came from its 4 MB VMEM block cap;
# here the rows live in device memory (iters x lanes x 16 B), and the bound
# is kept so both packages take the fused path for the same renders.
MAX_RECORD_ITERS = 256
MAX_TEXTURES = 16  # the JAX replay's select-sum / gather split (one kernel here)

# Leaves whose cotangents the fused path handles exactly (see the module
# docstring), in the order the autograd Function takes them; geometry
# leaves are not here.
_LEAVES = ("tex_ca", "tex_cb", "tex_cc", "mat_fuzz", "mat_ir", "atlas",
           "background")
SAFE_TRAINABLE = frozenset(_LEAVES)

# Bits of the replay kernel's ``flags`` (csrc/mega_replay.cu, enum Flags).
_HAS_CHECKER, _HAS_METAL, _HAS_DIEL = 1, 2, 4
DEFAULT_REPLAY_BLOCK = 128


def supports_diff(scene, cam, spp_cap: int, sample_stride: int,
                  max_depth: int) -> bool:
    per_lane_samples = -(-int(spp_cap) // max(int(sample_stride), 1))
    return (
        (mega_kernel.supports(scene, cam)
         or mega_kernel.supports_accel(scene, cam))
        and set(scene.mat_kinds) <= {scene_lib.MAT_LAMBERTIAN,
                                     scene_lib.MAT_METAL,
                                     scene_lib.MAT_DIELECTRIC,
                                     scene_lib.MAT_DIFFUSE_LIGHT}
        and set(scene.tex_kinds) <= {scene_lib.TEX_SOLID,
                                     scene_lib.TEX_CHECKER}
        and per_lane_samples * max_depth <= MAX_RECORD_ITERS
    )


def enabled(scene, cam, spp_cap, sample_stride, max_depth,
            trainable=None) -> bool:
    """Should the fused path run for this render?

    ``trainable`` is the caller's trainable-leaf names (grad/diff.py threads
    them through render_loss -> radiance_batch).  The fused path returns no
    geometry gradients, so:

      * auto mode (FUSED_DIFF None) engages only for a declared trainable set
        free of geometry leaves — an undeclared (None) set never does;
      * forced mode (FUSED_DIFF True) raises if a declared set holds a
        geometry leaf, instead of silently zeroing it.

    The JAX package's auto mode also requires a non-CPU backend, and leaves
    scenes with a sphere tree on the autodiff path, where the TPU measured
    the fused route 2.7x slower (mega_diff.py:142-153 there).  On the H100 the
    port's lockstep path is host-bound (hundreds of small ops per bounce):
    a fwd+bwd step on the random scene (360x270, spp 16, depth 8) took
    10.1 ms fused and 1,399 ms lockstep (chip_smoke.py's gate phase, H100
    80GB HBM3 at 700 W), so auto takes those scenes too.  The same gate
    decides on every device, and CPU tensors run the plain versions of both
    kernels.
    """
    if FUSED_DIFF is False:
        return False
    # Geometry leaves of kinds the supported class cannot contain have a
    # true gradient of zero, so training them through this path is exact.
    safe = set(SAFE_TRAINABLE) | {
        "tri_v0", "tri_v1", "tri_v2", "tri_uv0", "tri_uv1", "tri_uv2",
        "med_a", "med_b", "med_neg_inv_density"}
    geom = None if trainable is None else sorted(set(trainable) - safe)
    ok = supports_diff(scene, cam, spp_cap, sample_stride, max_depth)
    if FUSED_DIFF is True:
        if not ok:
            raise ValueError("FUSED_DIFF forced on but unsupported")
        if geom:
            raise ValueError(
                "FUSED_DIFF forced on, but the trainable set includes "
                f"geometry leaves {geom} whose gradients the fused path "
                "cannot give; set mega_diff.FUSED_DIFF = False for geometry "
                "training")
        return True
    return ok and geom == []


# --------------------------------------------------------------------------
# Replay backward: wrapper, CUDA launch and plain version
# --------------------------------------------------------------------------


def _flags(scene) -> int:
    return ((_HAS_CHECKER if scene_lib.TEX_CHECKER in scene.tex_kinds else 0)
            | (_HAS_METAL if scene_lib.MAT_METAL in scene.mat_kinds else 0)
            | (_HAS_DIEL if scene_lib.MAT_DIELECTRIC in scene.mat_kinds else 0))


def replay_backward(codes, tprev: V3, ghat: V3, ca, cb, bg, flags: int):
    """Gradients (tex_ca [T,3], tex_cb [T,3], background [3]) of
    sum(ghat * radiance) from the record rows of K2.

    ``codes`` int32 [iters, B], ``tprev`` V3 of [iters, B], ``ghat`` V3 of
    [B]; ``flags`` holds the scene's checker / metal / dielectric bits
    (``_flags``).  CUDA tensors launch ``csrc/mega_replay.cu``; CPU tensors
    run ``replay_backward_reference``; any other device raises.
    """
    dev = codes.device
    if codes.dtype != torch.int32 or codes.dim() != 2:
        raise TypeError("codes must be an int32 [iters, B] tensor")
    if dev.type == "cpu":
        return replay_backward_reference(codes, tprev, ghat, ca, cb, bg, flags)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    return _launch_replay(codes, tprev, ghat, ca, cb, bg, flags)


# Launches of the replay kernel (incremented once per launch, nowhere else).
replay_backward.launches = 0


def _lib():
    from another_raytracer_tpu_torch.ops.kernels import _build

    lib = _build.load("mega_replay")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.art_mega_replay.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P, P]
    lib.art_mega_replay.restype = I
    return lib


# Shared memory a block may use on an H100 (227 KB).
_MAX_SMEM = 232448


def replay_smem_bytes(T: int, block: int, shared_table: bool) -> int:
    """Shared-memory bytes of one replay block (``smem_bytes`` in
    csrc/mega_replay.cu): the albedo table, then the gradient columns, one
    per thread or one for the block."""
    tab = 6 * (T + 1)
    return 4 * (tab + (tab + 3) * (1 if shared_table else block))


def replay_instance(T: int):
    """(shared_table, block) of the replay launch for T textures: the
    deterministic per-lane columns while they fit at 32 threads or more
    (T <= 292), else the block-wide table with atomics (csrc/mega_replay.cu
    says why)."""
    # The per-thread columns: halve the block until they fit the default
    # 48 KB, and above that use the opt-in shared memory at 32 threads.
    block = DEFAULT_REPLAY_BLOCK
    while block > 32 and replay_smem_bytes(T, block, False) > 48 * 1024:
        block //= 2
    if replay_smem_bytes(T, block, False) <= _MAX_SMEM:
        return False, block
    if replay_smem_bytes(T, DEFAULT_REPLAY_BLOCK, True) > _MAX_SMEM:
        raise ValueError(f"{T} textures exceed the replay kernel's shared "
                         "memory")
    return True, DEFAULT_REPLAY_BLOCK


def prepare_replay(codes, tprev, ghat, ca, cb, bg, flags):
    """Everything one replay launch needs: returns (run, partial).
    ``run()`` is the bare launch (it returns the CUDA error code) and
    ``partial`` the [blocks, 6 (T+1) + 3] rows it fills."""
    dev = codes.device
    iters, B = codes.shape
    T = ca.shape[0]
    lib = _lib()
    shared_table, block = replay_instance(T)
    f32 = dict(dtype=torch.float32, device=dev)
    ins = (codes.contiguous(),
           torch.stack(tuple(tprev)).to(**f32).contiguous(),
           torch.stack(tuple(ghat)).to(**f32).contiguous(),
           ca.detach().to(**f32).contiguous(), cb.detach().to(**f32).contiguous(),
           bg.detach().to(**f32).contiguous())
    partial = torch.empty((-(-B // block), 6 * (T + 1) + 3), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in ins]

    def run(_inputs=ins):  # the default keeps the tensors behind ptrs alive
        return lib.art_mega_replay(*ptrs, iters, B, T, int(flags), block,
                                   int(shared_table), partial.data_ptr(),
                                   stream)

    return run, partial


def _launch_replay(codes, tprev, ghat, ca, cb, bg, flags):
    run, partial = prepare_replay(codes, tprev, ghat, ca, cb, bg, flags)
    with torch.cuda.device(codes.device):
        err = run()
    if err != 0:
        raise RuntimeError(f"mega_replay launch failed: CUDA error {err}")
    if codes.shape[1]:
        replay_backward.launches += 1
    T = ca.shape[0]
    tot = partial.sum(dim=0)
    tab = tot[:6 * (T + 1)].reshape(2, T + 1, 3)
    grad_cb = (tab[1, :T] if flags & _HAS_CHECKER
               else torch.zeros_like(tab[1, :T]))
    return tab[0, :T], grad_cb, tot[6 * (T + 1):]


def replay_backward_reference(codes, tprev: V3, ghat: V3, ca, cb, bg,
                              flags: int):
    """The replay as tensor ops on [B] lanes (any device): the per-lane
    reverse loop of ``_traced_bwd`` — each lane's gradients accumulate over
    its rows, then the lanes are summed.  Same contract as
    ``replay_backward``."""
    iters, B = codes.shape
    T = ca.shape[0]
    has_checker = bool(flags & _HAS_CHECKER)
    has_metal = bool(flags & _HAS_METAL)
    dev = codes.device
    f32 = dict(dtype=torch.float32, device=dev)
    sentinel = torch.full((1, 3), 1.0 if flags & _HAS_DIEL else 0.0, **f32)
    tab = torch.stack([torch.cat([ca.detach().to(**f32), sentinel]),
                       torch.cat([cb.detach().to(**f32), sentinel])])
    tab = tab.reshape(2 * (T + 1), 3)
    g = torch.stack(tuple(ghat), dim=1).to(**f32)  # [B,3]
    bgv = bg.detach().to(**f32)
    acc = torch.zeros((B, 2 * (T + 1), 3), **f32)
    gbg = torch.zeros((B, 3), **f32)
    r = torch.zeros((B, 3), **f32)
    lanes = torch.arange(B, device=dev)
    zero = torch.zeros((), **f32)
    for it in reversed(range(iters)):
        code = codes[it].long()
        ev = code & 3
        end = ((code & 4) != 0)[:, None]
        odd = (code & 8) != 0 if has_checker else torch.zeros_like(end[:, 0])
        slot = odd.long() * (T + 1) + torch.clamp(code >> 4, max=T)
        tp = torch.stack([tprev.x[it], tprev.y[it], tprev.z[it]], dim=1)
        scat, light, miss = ((ev == k)[:, None] for k in (1, 2, 3))
        r_after = torch.where(end, zero, r)
        gterm = g * tp
        gbg = gbg + torch.where(miss, gterm, zero)
        contrib = (torch.where(scat, gterm * r_after, zero)
                   + torch.where(light, gterm, zero))
        acc[lanes, slot] += contrib
        a = tab[slot]
        r = torch.where(scat, a * r_after,
                        torch.where(light, a, torch.where(miss, bgv, r)))
        if has_metal:
            r = torch.where((ev[:, None] == 0) & end, zero, r)
    tot = acc.sum(dim=0)
    grad_cb = tot[T + 1:2 * T + 1] if has_checker else torch.zeros((T, 3), **f32)
    return tot[:T], grad_cb, gbg.sum(dim=0)


# --------------------------------------------------------------------------
# The autograd Function and its entry point
# --------------------------------------------------------------------------


class _Traced(torch.autograd.Function):
    """Forward: K2 on the scene with the given leaves swapped in (the row
    pack is built under no_grad, as autograd runs a Function's forward).
    Backward: the replay.  Inputs after the fixed ones are the leaves of
    ``_LEAVES`` in order; outputs are the radiance channels [B] and the
    segment count, which is not differentiable."""

    @staticmethod
    def forward(ctx, cfg, scene, cam, pixel_ids, sample_ids0, seed, *leaves):
        (width, height, sample_stride, spp_cap, max_depth, t_min,
         record_iters) = cfg
        s = scene.replace(**{k: v.detach() for k, v in zip(_LEAVES, leaves)})
        total, segments, codes, tprev = mega_kernel.trace_regenerative_mega(
            s, cam, pixel_ids, sample_ids0, seed, width=width, height=height,
            sample_stride=sample_stride, sample_end=spp_cap, spp_cap=spp_cap,
            max_depth=max_depth, t_min=t_min, record_iters=record_iters)
        ctx.save_for_backward(codes, *tprev, s.tex_ca, s.tex_cb, s.background)
        ctx.flags = _flags(scene)
        ctx.leaf_like = [(v.shape, v.dtype, v.device) for v in leaves]
        ctx.mark_non_differentiable(segments)
        return total.x, total.y, total.z, segments

    @staticmethod
    def backward(ctx, gx, gy, gz, _gseg):
        codes, tpx, tpy, tpz, ca, cb, bg = ctx.saved_tensors
        grad_ca, grad_cb, grad_bg = replay_backward(
            codes, V3(tpx, tpy, tpz), V3(gx, gy, gz), ca, cb, bg, ctx.flags)
        grads = {"tex_ca": grad_ca, "tex_cb": grad_cb, "background": grad_bg}
        # The other declared leaves get zeros (JAX's _zero_cot), not None.
        out = tuple(grads[k].to(dt) if k in grads
                    else torch.zeros(shape, dtype=dt, device=dv)
                    for k, (shape, dt, dv) in zip(_LEAVES, ctx.leaf_like))
        return (None,) * 6 + out


def radiance_fused(scene, cam, pixel_ids, sample_ids0, seed, *, width, height,
                   sample_stride, spp_cap, max_depth, t_min):
    """Differentiable (V3 radiance [B], segments) via the fused path.

    ``spp_cap`` is the full sample budget: the fused path always traces the
    whole [0, spp_cap) range, as the bench and training entry points do.
    Gradients flow to the scene's ``_LEAVES`` tensors that require them.
    """
    per_lane = -(-int(spp_cap) // max(int(sample_stride), 1))
    cfg = (int(width), int(height), int(sample_stride), int(spp_cap),
           int(max_depth), float(t_min), per_lane * int(max_depth))
    x, y, z, segments = _Traced.apply(
        cfg, scene, cam, pixel_ids, sample_ids0, seed,
        *(getattr(scene, k) for k in _LEAVES))
    return V3(x, y, z), segments
