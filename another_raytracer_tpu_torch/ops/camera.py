"""Thin-lens perspective camera with defocus blur and a motion-blur shutter
(port of ``another_raytracer_tpu.ops.camera``).

Behavioral contract from the reference ``camera`` (src/engine/camera.h:8-47):
orthonormal basis from lookfrom/lookat/vup, viewport from vfov + aspect,
focal plane at ``focus_dist``, ``lens_radius = aperture/2``, per-ray lens-disk
origin jitter and a uniform random time in the shutter window [time0, time1].
Pixel addressing matches the reference sampler (src/engine/engine.h:58-68):
``u = (i + xi) / (W-1)``, ``v = ((H-1-j) + xi) / (H-1)`` — row j=0 is the top
of the image.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from another_raytracer_tpu_torch.ops import rng, vec3, vecmath
from another_raytracer_tpu_torch.ops.vec3 import V3

_VECTORS = ("origin", "lower_left", "horizontal", "vertical", "u", "v")
_SCALARS = ("lens_radius", "time0", "time1")


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor  # [3]
    lower_left: torch.Tensor  # [3]
    horizontal: torch.Tensor  # [3]
    vertical: torch.Tensor  # [3]
    u: torch.Tensor  # [3] camera-right basis vector
    v: torch.Tensor  # [3] camera-up basis vector
    lens_radius: torch.Tensor  # [] scalar
    time0: torch.Tensor  # [] shutter open
    time1: torch.Tensor  # [] shutter close
    # Static gates: skip the lens-disk / shutter-time draws for pinhole
    # cameras and zero-length shutters.  Draws are keyed per-purpose lanes,
    # so skipping one never shifts another.
    has_lens: bool = True
    has_time: bool = True

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device) for k in _VECTORS + _SCALARS})


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    vfov=40.0,
    aspect_ratio=4.0 / 3.0,
    aperture=0.0,
    focus_dist=10.0,
    time0=0.0,
    time1=0.0,
    device="cpu",
) -> Camera:
    """Construct the camera basis in float32 (reference ctor camera.h:8-36)."""
    f32 = dict(dtype=torch.float32, device=device)
    lookfrom = torch.as_tensor(lookfrom, **f32)
    lookat = torch.as_tensor(lookat, **f32)
    vup = torch.as_tensor(vup, **f32)

    theta = math.radians(float(vfov))
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = float(aspect_ratio) * viewport_height

    w = vecmath.unit(lookfrom - lookat)
    u = vecmath.unit(vecmath.cross(vup, w))
    v = vecmath.cross(w, u)

    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left = lookfrom - horizontal / 2 - vertical / 2 - focus_dist * w

    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=torch.tensor(aperture / 2.0, **f32),
        time0=torch.tensor(float(time0), **f32),
        time1=torch.tensor(float(time1), **f32),
        has_lens=float(aperture) != 0.0,
        has_time=float(time1) != float(time0),
    )


def camera_from_reference(cam, device="cpu") -> Camera:
    """Carry a JAX-package Camera across (``np.asarray`` on each leaf, static
    gates copied).  Reads attributes only; imports no JAX."""
    kw = {k: torch.from_numpy(np.array(np.asarray(getattr(cam, k)))).to(device)
          for k in _VECTORS + _SCALARS}
    return Camera(**kw, has_lens=bool(cam.has_lens), has_time=bool(cam.has_time))


def generate_rays(cam: Camera, pixel_ids, sample_ids, width: int, height: int,
                  seed, needs_time: "bool | None" = None):
    """Batched primary-ray generation.

    ``pixel_ids`` and ``sample_ids`` are int64 [B] tensors holding uint32
    values (flat pixel index ``j * width + i`` and sample index).  Returns
    (origins V3[B], directions V3[B], times [B]).  Matches
    ``engine::_stochastic_sample`` (engine.h:58-68) and ``camera::get_ray``
    (camera.h:38-47).
    """
    i = (pixel_ids % width).to(torch.float32)
    j = (pixel_ids // width).to(torch.float32)

    ju, jv = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE,
                          rng.DIM_PIXEL_JITTER)
    s = (i + ju) / float(width - 1)
    t = (float(height - 1) - j + jv) / float(height - 1)

    cam_origin = V3.from_array(cam.origin)
    base = V3.from_array(cam.lower_left - cam.origin)
    hor = V3.from_array(cam.horizontal)
    ver = V3.from_array(cam.vertical)

    if cam.has_lens:
        # Defocus: lens-disk origin jitter (camera.h:38-43).
        lu, lv = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE,
                              rng.DIM_LENS)
        rdx, rdy = vec3.in_unit_disk_from_uniforms(lu, lv)
        rdx = cam.lens_radius * rdx
        rdy = cam.lens_radius * rdy
        offset = V3.from_array(cam.u) * rdx + V3.from_array(cam.v) * rdy
        origin = offset + cam_origin
        direction = base + hor * s + ver * t - offset
    else:
        # Pinhole: offset == 0 exactly; broadcast the shared origin to [B].
        origin = V3(*(c.expand_as(s) for c in cam_origin))
        direction = base + hor * s + ver * t

    if needs_time is None:
        needs_time = cam.has_time
    if cam.has_time and needs_time:
        tu, _ = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE,
                             rng.DIM_TIME)
        time = cam.time0 + tu * (cam.time1 - cam.time0)
    else:
        # Zero-length shutter, or nothing in the scene reads ray time.
        time = cam.time0.expand_as(s)
    return origin, direction, time
