"""Batched 3-vector math on ``[..., 3]`` tensors (port of the part of
``another_raytracer_tpu.ops.vecmath`` that the camera uses)."""

from __future__ import annotations

import torch


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(dot(a, a))


def unit(a):
    """Normalize along the last axis (safe for zero vectors: returns 0)."""
    n = length(a)[..., None]
    return a / torch.where(n > 0, n, torch.ones_like(n))
