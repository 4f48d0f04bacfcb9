"""Radiance-to-pixel conversion (port of ``another_raytracer_tpu.ops.color``).

Behavioral contract from the reference ``write_color`` (src/core/color.h:7-30):
divide the per-pixel radiance sum by spp, gamma-2 correct via sqrt, clamp each
channel to [0, 0.999], scale by 256 and truncate to the integer type.
"""

from __future__ import annotations

import torch


def resolve(radiance_sum, samples_per_pixel):
    """Radiance sum [..., 3] -> gamma-corrected float in [0, 0.999]."""
    scale = 1.0 / samples_per_pixel
    c = torch.sqrt(torch.clamp_min(radiance_sum * scale, 0.0))
    return torch.clamp(c, 0.0, 0.999)


def to_uint8(radiance_sum, samples_per_pixel):
    """Radiance sum [..., 3] -> uint8 pixel values (color.h:13-22)."""
    return (256.0 * resolve(radiance_sum, samples_per_pixel)).to(torch.uint8)


def to_int32_gamma(radiance_sum, samples_per_pixel):
    """Radiance sum -> gamma-corrected int32 work values, as used by the
    adaptive mode's integer work frame (engine.h:172-173, 228-231)."""
    return (256.0 * resolve(radiance_sum, samples_per_pixel)).to(torch.int32)
