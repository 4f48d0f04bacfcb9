"""Texture evaluation, emission and branchless material scatter (port of
``another_raytracer_tpu.ops.shade``): solid, checker, Perlin noise, image
and barycentric textures; lambertian, metal, dielectric and diffuse-light
materials.

Every ray evaluates the closed-form candidates of the kinds the scene holds
and a masked select keyed on the material / texture kind picks the winner;
kinds the scene does not hold are not evaluated (``scene.mat_kinds`` /
``scene.tex_kinds`` gate them, as in the JAX package).

Scatter contracts (reference locations): lambertian dir = normal +
random_unit_vector with a near-zero fallback (material.h:20-43); metal
reflect(unit(d), n) + fuzz * random_in_unit_sphere, absorbed below the
surface (material.h:45-61); dielectric attenuation 1, ratio by front face,
TIR test and Schlick reflectance vs a uniform (material.h:63-99);
diffuse_light never scatters and emits its texture (material.h:101-118).

Perlin noise: ``perlin_noise`` is the plain version (direct ``index_select``
gathers of the tables), differentiable in the point; the forward path
(``fast_texel``) and differentiable renders whose trainable set cannot reach
the noise argument (``noise_value_only``) evaluate it through the kernel K4
(``ops/kernels/perlin_kernel.py``).  Image textures gather the atlas row of
the nearest texel.

Not ported: the isotropic material of media (ROADMAP M15) raises
NotImplementedError; the TPU-only packed atlas and its ``ATLAS_*`` knobs and
the one-hot ``Lookup`` gathers are left out (M21).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import rng, vec3
from another_raytracer_tpu_torch.ops.intersect import HitRecord, take
from another_raytracer_tpu_torch.ops.vec3 import V3

PERLIN_N = scene_lib.PERLIN_POINT_COUNT


def check_supported(scene):
    """Raise NotImplementedError for material kinds not ported."""
    if scene_lib.MAT_ISOTROPIC in scene.mat_kinds:
        raise NotImplementedError(
            "the isotropic material of media is not ported yet (ROADMAP M15)")


# Differentiable renders whose declared trainable set cannot reach the noise
# argument may evaluate Perlin noise through the kernel with a zero gradient
# in the point (``render.radiance_batch`` decides; exact there, since the
# point has no trainable dependence).  A context variable, as in the JAX
# package, scoped to one render call.
_NOISE_VALUE_ONLY = contextvars.ContextVar("noise_value_only", default=False)


@contextlib.contextmanager
def noise_value_only(flag: bool):
    tok = _NOISE_VALUE_ONLY.set(bool(flag))
    try:
        yield
    finally:
        _NOISE_VALUE_ONLY.reset(tok)


# --------------------------------------------------------------------------
# Perlin noise (perlin.h)
# --------------------------------------------------------------------------


def perlin_noise(scene, perlin_ids, p: V3):
    """Gradient Perlin noise per ray ([B] in roughly [-1, 1]): the plain
    version of K4.

    Lattice hash perm_x[i&255] ^ perm_y[j&255] ^ perm_z[k&255] and trilinear
    Hermite-smoothed gradient interpolation as perlin.h:29-96; each noise
    texture has its own tables (texture.h:52-65).  The +1 lattice neighbour
    is entry (i+1)&255.  The operations and their order are the kernel's
    (``csrc/perlin_kernel.cu``)."""
    pid = torch.clamp(torch.as_tensor(perlin_ids, device=p.x.device).long(),
                      0, scene.per_perm.shape[0] - 1)
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    u, v, w = p.x - fx, p.y - fy, p.z - fz
    ijk = [f.to(torch.int32).long() for f in (fx, fy, fz)]
    # Hermite smoothing u*u*(3-2u) (perlin.h:80-82).
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)

    perm = scene.per_perm.reshape(-1).long()  # [Q*3*256]
    ran = scene.per_ranvec.reshape(-1, 3)  # [Q*256, 3]
    base = pid * (3 * PERLIN_N)
    pv = []  # pv[axis] = (value at +0, value at +1)
    for axis, iv in enumerate(ijk):
        row = base + axis * PERLIN_N
        pv.append((perm.index_select(0, row + (iv & (PERLIN_N - 1))),
                   perm.index_select(0, row + ((iv + 1) & (PERLIN_N - 1)))))

    accum = torch.zeros_like(p.x)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gidx = pv[0][di] ^ pv[1][dj] ^ pv[2][dk]
                g = V3.from_array(ran.index_select(0, pid * PERLIN_N + gidx))
                wgt = ((uu if di else 1.0 - uu) * (vv if dj else 1.0 - vv)
                       * (ww if dk else 1.0 - ww))
                offset = V3(u - 1.0 if di else u, v - 1.0 if dj else v,
                            w - 1.0 if dk else w)
                accum = accum + wgt * vec3.dot(g, offset)
    return accum


def perlin_turb(scene, perlin_ids, p: V3, depth: int = 7):
    """7-octave fBm |accum| (perlin.h:42-54) — part of the reference API
    surface (unused by the stock noise_texture but kept for parity)."""
    accum = torch.zeros_like(p.x)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * perlin_noise(scene, perlin_ids, q)
        weight *= 0.5
        q = q * 2.0
    return accum.abs()


def texture_value(scene, tex_ids, u, v, tu, tv, p: V3,
                  fast_texel: bool = False) -> V3:
    """Evaluate the texture table for a batch.

    (u, v) are the raw surface parameters (barycentric for triangles) feeding
    TEX_BARYCENTRIC; (tu, tv) are the image-sampling coordinates — for
    triangles the barycentric blend of vertex texcoords (texture.h:135-154),
    identical to (u, v) for every other primitive.

    ``fast_texel`` (forward-only renders): Perlin noise goes through the
    kernel K4, which has no gradient in the point; the differentiable path
    keeps the plain version unless ``noise_value_only`` is set.
    """
    tid = torch.clamp(tex_ids, 0, scene.tex_kind.shape[0] - 1)
    kind = scene.tex_kind[tid]
    out = _gather3(scene.tex_ca, tid)  # TEX_SOLID
    kinds = scene.tex_kinds

    if scene_lib.TEX_CHECKER in kinds:
        # Checker: sign of sin(10x) sin(10y) sin(10z) (texture.h:39-45).
        cb = _gather3(scene.tex_cb, tid)
        sines = vec3.sin(10.0 * p.x) * vec3.sin(10.0 * p.y) * vec3.sin(10.0 * p.z)
        out = vec3.where((kind == scene_lib.TEX_CHECKER) & (sines < 0.0), cb, out)

    if scene_lib.TEX_NOISE in kinds:
        # Perlin: 0.5*(1+noise(scale*p)) grayscale (texture.h:57-59).
        scale = take(scene.tex_scale, tid)
        aux = scene.tex_aux[tid]
        q = p * scale
        if fast_texel or _NOISE_VALUE_ONLY.get():
            from another_raytracer_tpu_torch.ops.kernels import perlin_kernel

            noise = perlin_kernel.perlin_noise_nograd(
                scene, aux, q.map(torch.Tensor.detach))
        else:
            noise = perlin_noise(scene, aux, q)
        gray = 0.5 * (1.0 + noise)
        out = vec3.where(kind == scene_lib.TEX_NOISE, V3(gray, gray, gray), out)

    if scene_lib.TEX_IMAGE in kinds:
        # Image: clamp u, flip v, nearest texel (texture.h:88-111), one row
        # gather of the atlas.
        img = torch.clamp(scene.tex_aux[tid].long(), 0, scene.img_off.shape[0] - 1)
        w, h = scene.img_w[img].long(), scene.img_h[img].long()
        cu = torch.clamp(tu, 0.0, 1.0)
        cv = 1.0 - torch.clamp(tv, 0.0, 1.0)
        i = torch.minimum((cu * w.to(p.x.dtype)).to(torch.int32).long(), w - 1)
        j = torch.minimum((cv * h.to(p.x.dtype)).to(torch.int32).long(), h - 1)
        texel = _gather3(scene.atlas, scene.img_off[img].long() + j * w + i)
        out = vec3.where(kind == scene_lib.TEX_IMAGE, texel, out)

    if scene_lib.TEX_BARYCENTRIC in kinds:
        # Barycentric colour blend u*A + v*B + (1-u-v)*C (texture.h:121-133).
        ca = _gather3(scene.tex_ca, tid)
        cb = _gather3(scene.tex_cb, tid)
        cc = _gather3(scene.tex_cc, tid)
        bary = ca * u + cb * v + cc * (1.0 - u - v)
        out = vec3.where(kind == scene_lib.TEX_BARYCENTRIC, bary, out)
    return out


def _gather3(table, idx) -> V3:
    return V3.from_array(take(table, idx))


def emitted(scene, rec: HitRecord, fast_texel: bool = False) -> V3:
    """diffuse_light emits its texture; everything else black
    (material.h:12-14, 112-114)."""
    zero = torch.zeros_like(rec.u)
    if scene_lib.MAT_DIFFUSE_LIGHT not in scene.mat_kinds:
        return V3(zero, zero, zero)
    kind = scene.mat_kind[rec.mat]
    emit = texture_value(scene, scene.mat_tex[rec.mat].long(), rec.u, rec.v,
                         rec.tu, rec.tv, rec.p, fast_texel)
    return vec3.where(kind == scene_lib.MAT_DIFFUSE_LIGHT, emit,
                      V3(zero, zero, zero))


def scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids, bounce,
            seed, fast_texel: bool = False):
    """Branchless scatter for a batch of hits.  Returns (scatter_dir V3 — not
    normalised, as the reference's scattered rays; attenuation V3;
    scatter_ok [B])."""
    _, direction, attenuation, ok = emit_and_scatter(
        scene, rec, d_in, pixel_ids, sample_ids, bounce, seed, fast_texel,
        want_emit=False)
    return direction, attenuation, ok


def emit_and_scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids,
                     bounce, seed, fast_texel: bool = False,
                     want_emit: bool = True):
    """Fused ``emitted`` + ``scatter`` for one bounce: both read the
    material's single texture, so one table read and one texture evaluation
    serve both (engine.h:460-465).

    Returns (emit V3, scatter_dir V3, attenuation V3, scatter_ok [B]).
    """
    check_supported(scene)
    kinds = scene.mat_kinds
    kind = scene.mat_kind[rec.mat]
    tex = scene.mat_tex[rec.mat].long()
    n = rec.normal

    u1, u2 = rng.uniform2(seed, pixel_ids, sample_ids, bounce, rng.DIM_SCATTER_A)
    rand_unit = vec3.unit_vector_from_uniforms(u1, u2)
    has_metal = scene_lib.MAT_METAL in kinds
    has_diel = scene_lib.MAT_DIELECTRIC in kinds
    # Lanes 2,3 feed only the metal fuzz radius and the dielectric coin; a
    # lambertian/light-only scene skips that threefry block.  Draws are keyed
    # per purpose, so skipping one never shifts another.
    if has_metal or has_diel:
        u3, u4 = rng.uniform2(seed, pixel_ids, sample_ids, bounce,
                              rng.DIM_SCATTER_B)
    unit_d = vec3.unit(d_in) if (has_metal or has_diel) else d_in

    # lambertian (material.h:29-36)
    lam_dir = n + rand_unit
    direction = vec3.where(vec3.near_zero(lam_dir), n, lam_dir)
    ok = torch.ones(u1.shape, dtype=torch.bool, device=u1.device)

    if has_metal:
        # metal (material.h:52-55)
        fuzz = take(scene.mat_fuzz, rec.mat)
        met_dir = vec3.reflect(unit_d, n) + (rand_unit * vec3.cbrt(u3)) * fuzz
        met_ok = vec3.dot(met_dir, n) > 0.0
        is_met = kind == scene_lib.MAT_METAL
        direction = vec3.where(is_met, met_dir, direction)
        ok = torch.where(is_met, met_ok, ok)

    if has_diel:
        # dielectric (material.h:70-99)
        ir = take(scene.mat_ir, rec.mat)
        ratio = torch.where(rec.front_face, 1.0 / ir, ir)
        cos_theta = torch.clamp_max(vec3.dot(-unit_d, n), 1.0)
        # 1e-12 floor: finite gradient at grazing incidence (vec3.refract).
        sin_theta = vec3.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 1e-12))
        cannot_refract = ratio * sin_theta > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        # (1 - cos)^5 as XLA's integer power multiplies it out.
        c = 1.0 - cos_theta
        reflectance = r0 + (1.0 - r0) * (c * ((c * c) * (c * c)))
        die_dir = vec3.where(cannot_refract | (reflectance > u4),
                             vec3.reflect(unit_d, n),
                             vec3.refract(unit_d, n, ratio))
        direction = vec3.where(kind == scene_lib.MAT_DIELECTRIC, die_dir,
                               direction)

    tex_val = texture_value(scene, tex, rec.u, rec.v, rec.tu, rec.tv, rec.p,
                            fast_texel)
    attenuation = tex_val
    if has_diel:
        one = torch.ones_like(u1)
        attenuation = vec3.where(kind == scene_lib.MAT_DIELECTRIC,
                                 V3(one, one, one), attenuation)
    zero = torch.zeros_like(u1)
    emit = V3(zero, zero, zero)
    if scene_lib.MAT_DIFFUSE_LIGHT in kinds:
        is_light = kind == scene_lib.MAT_DIFFUSE_LIGHT
        ok = ok & ~is_light
        if want_emit:
            emit = vec3.where(is_light, tex_val, emit)
    return emit, direction, attenuation, ok
