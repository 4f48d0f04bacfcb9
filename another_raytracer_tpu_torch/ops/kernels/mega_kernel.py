"""The forward megakernel: the ENTIRE regenerating forward wavefront of a
sweep-only scene in one kernel (port of
``another_raytracer_tpu.ops.pallas.mega_kernel``, sweep mode).

Per ray lane the kernel runs camera ray generation (engine.h:58-68 +
camera.h:38-47), counter-based threefry draws (ops/rng.py), the closest-hit
sweep over world-baked primitive rows (spheres first, then rects — the fold
order of intersect.closest_hit), lambertian / metal / dielectric /
diffuse-light shading with solid / checker textures, and per-lane sample
regeneration until the lane's samples are spent.

* ``trace_regenerative_mega`` is the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/mega_kernel.cu`` (built at first use, see
  ``_build.py``) or raises; on CPU tensors it runs the plain version.
* ``trace_regenerative_mega_reference`` is the plain PyTorch version: the
  same per-lane algorithm as vectorised tensor ops on ``[B]`` lanes, with the
  same rows, keys and fold order.  It runs on any device; the CPU tests hold
  it against the JAX kernel in interpret mode, and ``chip_smoke.py`` holds
  the CUDA kernel against it on the card.

Geometry is pre-baked into world space per primitive row (``pack_rows``):
spheres as (c0, c1-c0, t0, 1/dt, r), rects as world parallelograms
(q0, eu, ev, n, d0 = n.q0, |eu|^2, |ev|^2), then shared material / texture
columns 16-26.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import rng, vec3
from another_raytracer_tpu_torch.ops.vec3 import V3

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
# Threads per CUDA block (one thread per lane).
DEFAULT_BLOCK = 128

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
                            block: int = DEFAULT_BLOCK, record_iters: int = 0):
    """Drop-in counterpart of the JAX ``trace_regenerative_mega`` (same
    arguments and return contract) for scenes where ``supports()`` holds.

    ``pixel_ids`` / ``sample_ids0`` are int64 [B] tensors of uint32 values;
    lanes whose first sample is >= min(sample_end, spp_cap) (for example
    0xFFFFFFFF) are born dead.  ``block`` is the CUDA block size (threads).
    Returns (radiance V3 of [B] per-lane sums, segments as an int64 scalar
    tensor).  CUDA tensors launch ``csrc/mega_kernel.cu``; CPU tensors run
    the plain version; any other device raises.
    """
    if record_iters:
        raise NotImplementedError(
            "record mode (the fused differentiable primal, kernel K2) is not "
            "ported yet (ROADMAP M12)")
    if not supports(scene, cam):
        raise ValueError("trace_regenerative_mega: scene not supported "
                         "(see supports())")
    _check_lanes(pixel_ids, sample_ids0, scene)
    kw = dict(width=width, height=height, sample_stride=sample_stride,
              sample_end=sample_end, spp_cap=spp_cap, max_depth=max_depth,
              t_min=t_min)
    if pixel_ids.device.type == "cpu":
        return trace_regenerative_mega_reference(
            scene, cam, pixel_ids, sample_ids0, seed, **kw)
    if pixel_ids.device.type != "cuda":
        raise ValueError(f"no megakernel for device {pixel_ids.device}")
    return _launch(scene, cam, pixel_ids, sample_ids0, seed, block=block, **kw)


# Launches of the CUDA kernel (incremented once per launch, nowhere else).
trace_regenerative_mega.launches = 0


def _u32_bits(x):
    """int64 tensor of uint32 values -> int32 tensor with the same bits."""
    x = x & rng.MASK32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def _lib():
    from another_raytracer_tpu_torch.ops.kernels import _build

    lib = _build.load("mega_kernel")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.art_mega_forward.argtypes = [
        P, I, I, P, P, P, I, U, U, U, I, I, I, F, I, I, P, P, P, P, P]
    lib.art_mega_forward.restype = I
    lib.art_threefry_words.argtypes = [U, U, P, P, I, P, P, P, P, P]
    lib.art_threefry_words.restype = I
    return lib


def _launch(scene, cam, pixel_ids, sample_ids0, seed, *, width, height,
            sample_stride, sample_end, spp_cap, max_depth, t_min, block):
    dev = pixel_ids.device
    if sample_stride < 1:
        raise ValueError("sample_stride must be >= 1")
    lib = _lib()
    rows = pack_rows(scene)
    camc = pack_camera(scene, cam)
    limit = min(int(sample_end), int(spp_cap), rng.MASK32)
    pix = _u32_bits(pixel_ids)
    samp = _u32_bits(sample_ids0)
    B = pixel_ids.shape[0]
    out = [torch.empty(B, dtype=torch.float32, device=dev) for _ in range(3)]
    seg = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.art_mega_forward(
            rows.data_ptr(), scene.n_spheres, scene.n_rects, camc.data_ptr(),
            pix.data_ptr(), samp.data_ptr(), B, int(seed) & rng.MASK32, limit,
            int(sample_stride), int(width), int(height), int(max_depth),
            float(t_min), _flags(scene, cam), int(block),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            seg.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mega_kernel launch failed: CUDA error {err}")
    if B:
        trace_regenerative_mega.launches += 1
    return V3(*out), seg.sum(dtype=torch.int64)


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
                                      max_depth: int, t_min: float):
    """The kernel's per-lane algorithm as tensor ops on [B] lanes (any
    device).  Every lane steps once per loop iteration while any lane is
    alive; a dead lane changes nothing, so each lane's result equals the
    kernel's own per-lane loop.  Same return contract as the wrapper."""
    _check_lanes(pixel_ids, sample_ids0, scene)
    f32 = np.float32
    rows = pack_rows(scene).reshape(-1, ROW_W)
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

    while bool(alive.any()):
        a_len = vec3.dot(d, d)
        best_t, r, b_n = _sweep(rows, ns, o, d, tm, a_len, t_min)
        hit = alive & (best_t < BIG)
        miss_now = alive & ~hit

        # ---- shade + scatter (shade.emit_and_scatter) ---------------------
        front = vec3.dot(b_n, d) < 0.0
        n = vec3.where(front, b_n, -b_n)
        p = o + d * best_t
        mk = r[:, _C_MKIND]
        alb = V3.from_array(r[:, _C_CA:_C_CA + 3])
        if has_checker:
            sines = (torch.sin(10.0 * p.x) * torch.sin(10.0 * p.y)
                     * torch.sin(10.0 * p.z))
            is_check = (r[:, _C_TKIND] == scene_lib.TEX_CHECKER) & (sines < 0.0)
            alb = vec3.where(is_check, V3.from_array(r[:, _C_CB:_C_CB + 3]), alb)

        u1, u2 = rng.uniform2(seed, pix, sample, bounce, rng.DIM_SCATTER_A)
        rand_unit = vec3.unit_vector_from_uniforms(u1, u2)
        if has_metal or has_diel:
            u3, u4 = rng.uniform2(seed, pix, sample, bounce, rng.DIM_SCATTER_B)
        if need_unit_d:
            inv_len = torch.rsqrt(torch.where(a_len > 0.0, a_len,
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
            sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
            cannot = ratio * sin_t > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            x = 1.0 - cos_t
            refl = r0 + (1.0 - r0) * (x * ((x * x) * (x * x)))
            rfl = unit_d - n * (2.0 * uddn)
            perp = (unit_d + n * cos_t) * ratio
            par = -torch.sqrt(torch.clamp_min((1.0 - vec3.dot(perp, perp)).abs(),
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
    return acc, seg.sum()


def _sweep(rows, ns, o: V3, d: V3, tm, a_len, t_min):
    """Closest hit over all rows as [B, N] tensor ops.  Each row's candidate
    t is the kernel's; the winner is the first row attaining the minimum,
    which is what the kernel's sequential strict-`<` fold keeps.  Returns
    (best_t [B] with BIG on a miss, the winner's row [B, ROW_W] (row 0 on a
    miss: read only where there is a hit), hit normal V3)."""
    cands = []
    inf = float("inf")
    if ns:
        s = rows[:ns]
        inv_a = (1.0 / torch.where(a_len > 0.0, a_len,
                                   torch.ones_like(a_len)))[:, None]
        frac = (tm[:, None] - s[:, 7]) * s[:, 8]
        cx = s[:, 1] + frac * s[:, 4]
        cy = s[:, 2] + frac * s[:, 5]
        cz = s[:, 3] + frac * s[:, 6]
        ocx, ocy, ocz = o.x[:, None] - cx, o.y[:, None] - cy, o.z[:, None] - cz
        half_b = ocx * d.x[:, None] + ocy * d.y[:, None] + ocz * d.z[:, None]
        c = ocx * ocx + ocy * ocy + ocz * ocz - s[:, 9] * s[:, 9]
        disc = half_b * half_b - a_len[:, None] * c
        ok = disc > 0.0
        sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
        root1 = (-half_b - sq) * inv_a
        t = torch.where(root1 > t_min, root1, (-half_b + sq) * inv_a)
        valid = ok & (t > t_min) & (t < BIG)
        cands.append(torch.where(valid, t, inf))
    if rows.shape[0] > ns:
        q = rows[ns:]
        ndotd = d.x[:, None] * q[:, 10] + d.y[:, None] * q[:, 11] + d.z[:, None] * q[:, 12]
        ndoto = o.x[:, None] * q[:, 10] + o.y[:, None] * q[:, 11] + o.z[:, None] * q[:, 12]
        ok = ndotd != 0.0
        t = (q[:, 13] - ndoto) / torch.where(ok, ndotd, torch.ones_like(ndotd))
        rx = o.x[:, None] + t * d.x[:, None] - q[:, 1]
        ry = o.y[:, None] + t * d.y[:, None] - q[:, 2]
        rz = o.z[:, None] + t * d.z[:, None] - q[:, 3]
        a = rx * q[:, 4] + ry * q[:, 5] + rz * q[:, 6]
        b = rx * q[:, 7] + ry * q[:, 8] + rz * q[:, 9]
        inside = (a >= 0.0) & (a <= q[:, 14]) & (b >= 0.0) & (b <= q[:, 15])
        valid = ok & inside & (t > t_min) & (t < BIG)
        cands.append(torch.where(valid, t, inf))
    t_all = torch.cat(cands, dim=1)
    best_t, best = torch.min(t_all, dim=1)
    best_t = torch.where(best_t < BIG, best_t, torch.full_like(best_t, BIG))

    r = rows[best]
    b_n = V3.from_array(r[:, 10:13])
    if ns:
        # Sphere winner: outward normal from the winning row's center at tm.
        frac = (tm - r[:, 7]) * r[:, 8]
        center = V3(r[:, 1] + frac * r[:, 4], r[:, 2] + frac * r[:, 5],
                    r[:, 3] + frac * r[:, 6])
        inv_r = 1.0 / r[:, 9]
        n_sph = ((o + d * best_t) - center) * inv_r
        b_n = vec3.where(best < ns, n_sph, b_n)
    return best_t, r, b_n
