"""Top-level render driver: pixels x samples -> radiance sums -> pixels (port
of ``another_raytracer_tpu.ops.render``, single mode, forward only).

Every forward render of a scene that the megakernel supports goes through
``mega_kernel.trace_regenerative_mega``: the hand-written CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors.  (The JAX package
sends spp == samples_per_pass renders through its lockstep scan instead;
the two agree bit for bit at samples_per_pass 1, render.py:69-74 there.)
Anything else raises NotImplementedError naming its ROADMAP item — no slower
fallback path.
"""

from __future__ import annotations

import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.ops import color as color_lib
from another_raytracer_tpu_torch.ops import rng
from another_raytracer_tpu_torch.ops.kernels import mega_kernel


def radiance_batch(scene, cam, pixel_ids, seed, *, width, height,
                   sample_start, n_samples, spp_cap, samples_per_pass,
                   max_depth, t_min, differentiable=False, lane_mask=None):
    """Radiance sums for an arbitrary pixel batch over samples
    [sample_start, sample_start + n_samples) ∩ [0, spp_cap).

    ``pixel_ids`` is an int64 [Np] tensor on the scene's device.  Rays are
    laid out sample-major: lane s*Np + p is pixel p starting at sample
    sample_start + s, and each lane walks its samples with stride
    ``samples_per_pass``.  ``lane_mask`` ([Np] bool, optional): lanes where
    False are pad lanes — born dead, contributing zero radiance and zero
    segments.

    Returns (radiance_sum V3 of [Np], segments int64 scalar tensor).
    """
    if differentiable:
        raise NotImplementedError(
            "differentiable renders (lockstep integrator, render_loss, the "
            "fused record-mode path) are not ported yet (ROADMAP M8, M10, M12)")
    if not mega_kernel.supports(scene, cam):
        raise NotImplementedError(
            "only sweep-only scenes the forward megakernel supports are "
            "ported (<= 64 spheres and rects; lambertian, metal, dielectric, "
            "diffuse light; solid and checker textures); textures, media, "
            "triangles and BVHs come later (ROADMAP M14-M17)")

    n_pixels = pixel_ids.shape[0]
    spass = min(samples_per_pass, n_samples)
    dev = pixel_ids.device

    pix = pixel_ids.repeat(spass)
    samp0 = (torch.arange(spass, dtype=torch.int64, device=dev)
             .repeat_interleave(n_pixels) + int(sample_start))
    if lane_mask is not None:
        # Pad lanes start past every sample limit -> born dead.
        samp0 = torch.where(lane_mask.repeat(spass), samp0,
                            torch.full_like(samp0, rng.MASK32))
    acc, segments = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, seed,
        width=width, height=height, sample_stride=spass,
        sample_end=int(sample_start) + n_samples, spp_cap=spp_cap,
        max_depth=max_depth, t_min=t_min,
    )
    acc = acc.map(lambda c: c.reshape(spass, n_pixels).sum(dim=0))
    return acc, segments


def render_radiance(scene, cam, seed, *, width, height, spp, samples_per_pass,
                    max_depth, t_min):
    """Per-pixel radiance sums over ``spp`` samples, un-averaged (averaging
    is deferred to write_color, engine.h:58-68).

    Returns (radiance_sum V3 of [H*W] in flat scanline order, segments).
    Sweep-only scenes are traced in scanline order (the JAX package uses
    Morton order only for BVH scenes, which the port does not render yet).
    """
    pixel_ids = torch.arange(width * height, dtype=torch.int64,
                             device=scene.device)
    return radiance_batch(
        scene, cam, pixel_ids, seed, width=width, height=height,
        sample_start=0, n_samples=spp, spp_cap=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
    )


def render(scene, cam, config: RenderConfig, progress=None):
    """Render to a uint8 image [H, W, 3] (numpy, on the host).

    Returns (image, stats dict with 'segments' — the honest bounce-ray count,
    unlike the reference's nominal primary-only kRay/s at main.cpp:50-53).
    The scene and camera decide the device; the image comes back to the host.
    """
    if scene.num_primitives == 0:
        raise ValueError("cannot render empty scene!")
    if config.mode != RenderMode.SINGLE:
        item = {RenderMode.ADAPTIVE: "M19",
                RenderMode.PARALLEL_STRIPES: "M18",
                RenderMode.PARALLEL_IMAGES: "M18"}[config.mode]
        raise NotImplementedError(
            f"render mode {config.mode.value!r} is not ported yet "
            f"(ROADMAP {item}); use mode 'single'")
    if progress is not None:
        raise NotImplementedError(
            "progress sinks (preview / live view) are not ported yet "
            "(ROADMAP M20)")

    acc, segments = render_radiance(
        scene, cam, config.seed,
        width=config.width, height=config.height, spp=config.samples_per_pixel,
        samples_per_pass=config.samples_per_pass, max_depth=config.max_depth,
        t_min=config.t_min,
    )
    img = color_lib.to_uint8(torch.stack(tuple(acc), dim=-1),
                             config.samples_per_pixel)
    img = img.cpu().numpy().reshape(config.height, config.width, 3)
    return img, {"segments": int(segments)}
