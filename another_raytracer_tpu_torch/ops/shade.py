"""Texture evaluation, emission and branchless material scatter (port of
``another_raytracer_tpu.ops.shade``, the main class: solid and checker
textures; lambertian, metal, dielectric and diffuse-light materials).

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

Not ported: noise, image and barycentric textures (ROADMAP M14) and the
isotropic material of media (M15) raise NotImplementedError.
"""

from __future__ import annotations

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import rng, vec3
from another_raytracer_tpu_torch.ops.intersect import HitRecord, take
from another_raytracer_tpu_torch.ops.vec3 import V3

_TEX_ITEM = {scene_lib.TEX_NOISE: "Perlin noise",
             scene_lib.TEX_IMAGE: "image",
             scene_lib.TEX_BARYCENTRIC: "barycentric"}


def check_supported(scene):
    """Raise NotImplementedError for texture / material kinds not ported."""
    missing = sorted(_TEX_ITEM[k] for k in scene.tex_kinds if k in _TEX_ITEM)
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)} textures are not ported yet (ROADMAP M14)")
    if scene_lib.MAT_ISOTROPIC in scene.mat_kinds:
        raise NotImplementedError(
            "the isotropic material of media is not ported yet (ROADMAP M15)")


def texture_value(scene, tex_ids, u, v, tu, tv, p: V3) -> V3:
    """Evaluate the texture table for a batch: solid colour, or the checker's
    sign of sin(10x) sin(10y) sin(10z) (texture.h:39-45)."""
    check_supported(scene)
    tid = torch.clamp(tex_ids, 0, scene.tex_kind.shape[0] - 1)
    out = _gather3(scene.tex_ca, tid)  # TEX_SOLID
    if scene_lib.TEX_CHECKER in scene.tex_kinds:
        kind = scene.tex_kind[tid]
        cb = _gather3(scene.tex_cb, tid)
        sines = vec3.sin(10.0 * p.x) * vec3.sin(10.0 * p.y) * vec3.sin(10.0 * p.z)
        out = vec3.where((kind == scene_lib.TEX_CHECKER) & (sines < 0.0), cb, out)
    return out


def _gather3(table, idx) -> V3:
    return V3.from_array(take(table, idx))


def emitted(scene, rec: HitRecord) -> V3:
    """diffuse_light emits its texture; everything else black
    (material.h:12-14, 112-114)."""
    zero = torch.zeros_like(rec.u)
    if scene_lib.MAT_DIFFUSE_LIGHT not in scene.mat_kinds:
        return V3(zero, zero, zero)
    kind = scene.mat_kind[rec.mat]
    emit = texture_value(scene, scene.mat_tex[rec.mat].long(), rec.u, rec.v,
                         rec.tu, rec.tv, rec.p)
    return vec3.where(kind == scene_lib.MAT_DIFFUSE_LIGHT, emit,
                      V3(zero, zero, zero))


def scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids, bounce,
            seed):
    """Branchless scatter for a batch of hits.  Returns (scatter_dir V3 — not
    normalised, as the reference's scattered rays; attenuation V3;
    scatter_ok [B])."""
    _, direction, attenuation, ok = emit_and_scatter(
        scene, rec, d_in, pixel_ids, sample_ids, bounce, seed, want_emit=False)
    return direction, attenuation, ok


def emit_and_scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids,
                     bounce, seed, want_emit: bool = True):
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

    tex_val = texture_value(scene, tex, rec.u, rec.v, rec.tu, rec.tv, rec.p)
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
