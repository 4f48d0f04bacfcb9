"""Batched 3-vector math on ``[..., 3]`` tensors (port of
``another_raytracer_tpu.ops.vecmath``): the same float32 formulas, and the
closed-form samplers that replace the reference's rejection loops
(src/core/vec3.h:117-143)."""

from __future__ import annotations

import math

import torch

from another_raytracer_tpu_torch.ops.vec3 import NEAR_ZERO_EPS, cbrt, cos, sin, sqrt


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_squared(a):
    return torch.sum(a * a, dim=-1)


def length(a):
    return sqrt(length_squared(a))


def unit(a):
    """Normalize along the last axis (safe for zero vectors: returns 0)."""
    n = length(a)[..., None]
    return a / torch.where(n > 0, n, torch.ones_like(n))


def near_zero(a):
    """True where all components are < 1e-8 in magnitude (vec3.h:49-53)."""
    return torch.all(a.abs() < NEAR_ZERO_EPS, dim=-1)


def reflect(v, n):
    """Mirror reflection about unit normal n (vec3.h:145-147)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction via perpendicular/parallel decomposition
    (vec3.h:149-154).  ``uv`` must be unit length.  The 1e-12 floor keeps the
    sqrt's gradient finite at the total-internal-reflection boundary."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = -sqrt(torch.clamp_min(
        (1.0 - length_squared(r_out_perp)).abs(), 1e-12))[..., None] * n
    return r_out_perp + r_out_parallel


def unit_vector_from_uniforms(u1, u2):
    """Uniform direction on the unit sphere from two uniforms (equal-area
    map replacing ``random_unit_vector``, vec3.h:125-127)."""
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def in_unit_sphere_from_uniforms(u1, u2, u3):
    """Uniform point in the unit ball (``random_in_unit_sphere``,
    vec3.h:117-123): a uniform direction scaled by the cube root of u3."""
    return unit_vector_from_uniforms(u1, u2) * cbrt(u3)[..., None]


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform point in the unit disk, z = 0 (``random_in_unit_disk``,
    vec3.h:137-143)."""
    r = sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([r * cos(phi), r * sin(phi),
                        torch.zeros_like(r)], dim=-1)


def in_hemisphere(d, normal):
    """Flip d into the hemisphere around ``normal`` (random_in_hemisphere,
    vec3.h:129-135)."""
    same = dot(d, normal) > 0.0
    return torch.where(same[..., None], d, -d)
