"""Column-SoA 3-vectors (port of ``another_raytracer_tpu.ops.vec3``, the part
the camera and the megakernel's plain version use).

A ``V3`` is three ``[B]`` tensors.  The port keeps it at public boundaries
(rays, radiance sums) so its tests compare like with like against the JAX
package; the CUDA kernel keeps its own per-thread registers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


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

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @staticmethod
    def from_array(a):
        """[..., 3] -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def map(self, f):
        return V3(f(self.x), f(self.y), f(self.z))


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def where(mask, a: V3, b: V3) -> V3:
    return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
              torch.where(mask, a.z, b.z))


# --- samplers (closed-form equivalents of vec3.h:117-143) ------------------


def unit_vector_from_uniforms(u1, u2) -> V3:
    """Uniform direction on the unit sphere (replaces random_unit_vector's
    rejection loop, vec3.h:125-127; identical distribution)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform (x, y) in the unit disk (replaces random_in_unit_disk,
    vec3.h:137-143).  Returns (x, y)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return r * torch.cos(phi), r * torch.sin(phi)


def to_numpy(v: V3) -> np.ndarray:
    """V3 -> np.ndarray [..., 3] on the host."""
    return np.stack([c.detach().cpu().numpy() for c in v], axis=-1)
