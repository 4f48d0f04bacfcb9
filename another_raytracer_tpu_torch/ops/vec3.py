"""Column-SoA 3-vectors (port of ``another_raytracer_tpu.ops.vec3``).

A ``V3`` is three ``[B]`` tensors.  The port keeps it at public boundaries
(rays, radiance sums) so its tests compare like with like against the JAX
package; the CUDA kernels keep their own per-thread registers.  The formulas
are the JAX package's, operation for operation, so float32 results agree.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

NEAR_ZERO_EPS = 1e-8  # reference: vec3::near_zero epsilon (vec3.h:51)


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @staticmethod
    def from_array(a):
        """[..., 3] -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def zeros_like(t):
        z = torch.zeros_like(t)
        return V3(z, z, z)

    def map(self, f):
        return V3(f(self.x), f(self.y), f(self.z))


def sqrt(x):
    """float32 sqrt, correctly rounded.  torch's vectorised CPU sqrt can be
    an ulp off; the float64 root rounds to the IEEE float32 value, which is
    what XLA and CUDA's sqrtf return, so the plain versions agree with the
    JAX package and give the same bits on the CPU and the card."""
    return torch.sqrt(x.double()).to(x.dtype)


def cos(x):
    """float32 cosine, correctly rounded (through float64): an ulp from
    XLA's on ~1% of inputs, where torch's own differs on ~5%."""
    return torch.cos(x.double()).to(x.dtype)


def sin(x):
    """float32 sine, correctly rounded (through float64); see ``cos``."""
    return torch.sin(x.double()).to(x.dtype)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length_squared(a: V3):
    return dot(a, a)


def length(a: V3):
    return sqrt(length_squared(a))


def unit(a: V3) -> V3:
    n = length(a)
    return a * (1.0 / torch.where(n > 0, n, torch.ones_like(n)))


def near_zero(a: V3):
    return ((a.x.abs() < NEAR_ZERO_EPS) & (a.y.abs() < NEAR_ZERO_EPS)
            & (a.z.abs() < NEAR_ZERO_EPS))


def where(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


def reflect(v: V3, n: V3) -> V3:
    """Mirror reflection about unit normal n (vec3.h:145-147)."""
    return v - n * (2.0 * dot(v, n))


def refract(uv: V3, n: V3, etai_over_etat) -> V3:
    """Snell refraction (vec3.h:149-154); uv must be unit.  The 1e-12 floor
    keeps the sqrt's gradient finite at total internal reflection."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    r_out_parallel = n * (-sqrt(torch.clamp_min(
        (1.0 - length_squared(r_out_perp)).abs(), 1e-12)))
    return r_out_perp + r_out_parallel


def rotate(rot_rows, v: V3) -> V3:
    """Apply a gathered rotation: ``rot_rows`` is a 3-tuple of V3 rows."""
    r0, r1, r2 = rot_rows
    return V3(dot(r0, v), dot(r1, v), dot(r2, v))


# --- samplers (closed-form equivalents of vec3.h:117-143) ------------------


def cbrt(u):
    """Cube root of u >= 0 in float32.  torch has no cbrt; the power is taken
    in float64, so the float32 result is the correctly rounded cube root
    (jnp.cbrt's is an ulp off on ~12% of inputs)."""
    return torch.pow(u.double(), 1.0 / 3.0).to(u.dtype)


def unit_vector_from_uniforms(u1, u2) -> V3:
    """Uniform direction on the unit sphere (replaces random_unit_vector's
    rejection loop, vec3.h:125-127; identical distribution)."""
    z = 1.0 - 2.0 * u1
    r = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2
    return V3(r * cos(phi), r * sin(phi), z)


def in_unit_sphere_from_uniforms(u1, u2, u3) -> V3:
    """Uniform point in the unit ball (replaces random_in_unit_sphere,
    vec3.h:117-123)."""
    return unit_vector_from_uniforms(u1, u2) * cbrt(u3)


def in_hemisphere_from_uniforms(u1, u2, u3, normal: V3) -> V3:
    """Uniform point in the unit half-ball about ``normal`` (replaces
    random_in_hemisphere, vec3.h:129-135; identical distribution)."""
    p = in_unit_sphere_from_uniforms(u1, u2, u3)
    return where(dot(p, normal) > 0.0, p, -p)


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform (x, y) in the unit disk (replaces random_in_unit_disk,
    vec3.h:137-143).  Returns (x, y)."""
    r = sqrt(u1)
    phi = 2.0 * math.pi * u2
    return r * cos(phi), r * sin(phi)


def to_numpy(v: V3) -> np.ndarray:
    """V3 -> np.ndarray [..., 3] on the host."""
    return np.stack([c.detach().cpu().numpy() for c in v], axis=-1)
