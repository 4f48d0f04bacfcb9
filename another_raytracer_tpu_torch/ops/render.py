"""Top-level render driver: pixels x samples -> radiance sums -> pixels (port
of ``another_raytracer_tpu.ops.render``, single mode; the adaptive mode is
``ops/adaptive.py``).

Every forward render that ``mega_kernel.enabled`` accepts goes through
``mega_kernel.trace_regenerative_mega`` (K1 on sweep scenes, K3 on scenes
whose spheres sit in one BVH: the hand-written CUDA kernel for CUDA tensors,
its plain PyTorch version for CPU tensors); every other forward render
through the regenerating wavefront ``integrator.trace_regenerative``, whose
bounces run the BVH kernel K5 and the Perlin kernel K4
(``mega_kernel.MEGA_FORWARD = False`` sends every forward render there).
(The JAX package sends spp == samples_per_pass renders through its lockstep
scan instead; the paths agree bit for bit at samples_per_pass 1,
render.py:69-74 there.)  Scenes with a BVH are traced in Morton pixel order.

Differentiable renders take the fused path (``mega_diff.radiance_fused``:
the record instance of K2 or K3 and the replay backward) when
``mega_diff.enabled`` accepts the scene and the declared trainable set, and
otherwise the lockstep autograd path (``integrator.trace``), as in the JAX
package; there Perlin noise runs through K4 with a zero gradient when the
declared trainable set cannot reach the noise argument.  Anything not
ported raises NotImplementedError naming its ROADMAP item — no slower
fallback path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import color as color_lib
from another_raytracer_tpu_torch.ops import integrator, rng, shade, vec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff, mega_kernel
from another_raytracer_tpu_torch.ops.vec3 import V3


def radiance_batch(scene, cam, pixel_ids, seed, *, width, height,
                   sample_start, n_samples, spp_cap, samples_per_pass,
                   max_depth, t_min, differentiable=False, trainable=None,
                   lane_mask=None):
    """Radiance sums for an arbitrary pixel batch over samples
    [sample_start, sample_start + n_samples) ∩ [0, spp_cap).

    ``pixel_ids`` is an int64 [Np] tensor on the scene's device.  Rays are
    laid out sample-major: lane s*Np + p is pixel p starting at sample
    sample_start + s, and each lane walks its samples with stride
    ``samples_per_pass``.  ``lane_mask`` ([Np] bool, optional): lanes where
    False are pad lanes — born dead, contributing zero radiance and zero
    segments.

    ``differentiable``: gradients flow to the scene's tensors that require
    them.  ``trainable`` (differentiable renders only) names the caller's
    trainable scene leaves; the fused path engages only for a declared set
    free of geometry leaves (``mega_diff.enabled``).

    Returns (radiance_sum V3 of [Np], segments int64 scalar tensor).
    """
    if differentiable:
        return _radiance_batch_diff(
            scene, cam, pixel_ids, seed, width=width, height=height,
            sample_start=sample_start, n_samples=n_samples, spp_cap=spp_cap,
            samples_per_pass=samples_per_pass, max_depth=max_depth,
            t_min=t_min, trainable=trainable, lane_mask=lane_mask)
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
    trace_fn = (mega_kernel.trace_regenerative_mega
                if mega_kernel.enabled(scene, cam)
                else integrator.trace_regenerative)
    acc, segments = trace_fn(
        scene, cam, pix, samp0, seed,
        width=width, height=height, sample_stride=spass,
        sample_end=int(sample_start) + n_samples, spp_cap=spp_cap,
        max_depth=max_depth, t_min=t_min,
    )
    acc = acc.map(lambda c: c.reshape(spass, n_pixels).sum(dim=0))
    return acc, segments


def _radiance_batch_diff(scene, cam, pixel_ids, seed, *, width, height,
                         sample_start, n_samples, spp_cap, samples_per_pass,
                         max_depth, t_min, trainable, lane_mask):
    """The differentiable branch of ``radiance_batch`` (render.py:102-179
    there): the fused path, else the lockstep autograd path."""
    n_pixels = pixel_ids.shape[0]
    spass = min(samples_per_pass, n_samples)
    n_chunks = -(-n_samples // spass)
    dev = pixel_ids.device
    pix = pixel_ids.repeat(spass)
    samp_offsets = torch.arange(spass, dtype=torch.int64,
                                device=dev).repeat_interleave(n_pixels)

    def per_pixel(c):
        return c.reshape(spass, n_pixels).sum(dim=0)

    if (int(sample_start) == 0 and n_samples == spp_cap
            and mega_diff.enabled(scene, cam, spp_cap, spass, max_depth,
                                  trainable=trainable)):
        if lane_mask is not None:
            # ROADMAP F2: the JAX fused branch drops lane_mask silently, so
            # pad lanes would add radiance and gradients.
            raise ValueError(
                "lane_mask is not supported on the fused differentiable path "
                "(ROADMAP F2); pass the real pixels only, or set "
                "mega_diff.FUSED_DIFF = False")
        acc, segments = mega_diff.radiance_fused(
            scene, cam, pix, samp_offsets, seed, width=width, height=height,
            sample_stride=spass, spp_cap=spp_cap, max_depth=max_depth,
            t_min=t_min)
        return acc.map(per_pixel), segments

    # Lockstep autograd path: one pass per chunk of samples_per_pass samples.
    lanes_ok = None if lane_mask is None else lane_mask.repeat(spass)
    zero = torch.zeros(n_pixels, dtype=torch.float32, device=dev)
    acc = V3(zero, zero, zero)
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    with shade.noise_value_only(noise_value_only(scene, trainable)):
        for chunk in range(n_chunks):
            sample_ids = ((samp_offsets + int(sample_start) + chunk * spass)
                          & rng.MASK32)
            o, d, time = camera_lib.generate_rays(
                cam, pix, sample_ids, width, height, seed,
                needs_time=scene.has_motion)
            radiance, segs = integrator.trace(
                scene, o, d, time, pix, sample_ids, seed, max_depth, t_min)
            # Mask samples beyond the range (ragged last chunk / spp cap).
            valid = ((sample_ids < int(sample_start) + n_samples)
                     & (sample_ids < spp_cap))
            if lanes_ok is not None:
                valid = valid & lanes_ok
            radiance = vec3.where(valid, radiance, V3.zeros_like(radiance.x))
            acc = acc + radiance.map(per_pixel)
            segments = segments + segs
    return acc, segments


# Leaf-name prefixes that reach the noise argument (the hit point) or the
# Perlin tables (render.py:153 there).
_ARG_LEAVES = ("sph_", "rect_", "tri_", "med_", "per_", "xf_")


def noise_value_only(scene, trainable) -> bool:
    """The JAX package's value-only noise rule (render.py:139-178 there): a
    differentiable render may evaluate Perlin noise without a gradient in
    the point when the declared trainable set cannot reach it — no geometry,
    transform, Perlin-table or ``tex_scale`` leaf, and no ``mat_fuzz`` /
    ``mat_ir`` on a scene with metal / dielectric (they steer directions,
    hence later hit points, and noise is continuous in the point).  An
    undeclared set (None) never qualifies."""
    if trainable is None:
        return False
    geom_reach = any(k.startswith(_ARG_LEAVES) or k == "tex_scale"
                     for k in trainable)
    dir_reach = (
        ("mat_fuzz" in trainable and scene_lib.MAT_METAL in scene.mat_kinds)
        or ("mat_ir" in trainable
            and scene_lib.MAT_DIELECTRIC in scene.mat_kinds))
    return not geom_reach and not dir_reach


@functools.lru_cache(maxsize=32)
def morton_order(width: int, height: int):
    """Z-order (Morton) pixel traversal for a WxH image.

    Returns (order, inverse) uint32 numpy arrays: ``order[k]`` is the flat
    pixel id of the k-th ray.  Neighbouring lanes then cover a compact
    square tile instead of a scanline strip, so a warp's BVH walks mostly
    coincide.  Radiance is unaffected: the RNG keys on absolute pixel ids.
    """
    def part1by1(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    gx, gy = np.meshgrid(np.arange(width, dtype=np.uint32),
                         np.arange(height, dtype=np.uint32))
    code = part1by1(gx) | (part1by1(gy) << np.uint32(1))
    order = np.argsort(code.ravel(), kind="stable").astype(np.uint32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.uint32)
    order.flags.writeable = False
    inv.flags.writeable = False
    return order, inv


def render_radiance(scene, cam, seed, *, width, height, spp, samples_per_pass,
                    max_depth, t_min, differentiable=False, trainable=None):
    """Per-pixel radiance sums over ``spp`` samples, un-averaged (averaging
    is deferred to write_color, engine.h:58-68).

    Returns (radiance_sum V3 of [H*W] in flat scanline order, segments).
    Scenes with a BVH are traced in Morton order (``morton_order``), the
    others in scanline order, as in the JAX package.
    """
    dev = scene.device
    if scene.has_accel:
        order, inv = morton_order(width, height)
        pixel_ids = torch.from_numpy(order.astype(np.int64)).to(dev)
    else:
        pixel_ids = torch.arange(width * height, dtype=torch.int64, device=dev)
    acc, segments = radiance_batch(
        scene, cam, pixel_ids, seed, width=width, height=height,
        sample_start=0, n_samples=spp, spp_cap=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
        differentiable=differentiable, trainable=trainable,
    )
    if scene.has_accel:
        inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
        acc = acc.map(lambda c: c.index_select(0, inv_t))
    return acc, segments


def render(scene, cam, config: RenderConfig, progress=None):
    """Render to a uint8 image [H, W, 3] (numpy, on the host).

    Returns (image, stats dict with 'segments' — the honest bounce-ray count,
    unlike the reference's nominal primary-only kRay/s at main.cpp:50-53).
    The scene and camera decide the device; the image comes back to the host.
    """
    if scene.num_primitives == 0:
        raise ValueError("cannot render empty scene!")
    if config.mode in (RenderMode.PARALLEL_STRIPES, RenderMode.PARALLEL_IMAGES):
        raise NotImplementedError(
            f"render mode {config.mode.value!r} is not ported yet "
            "(ROADMAP M18); use mode 'single' or 'adaptive'")
    if progress is not None:
        raise NotImplementedError(
            "progress sinks (preview / live view) are not ported yet "
            "(ROADMAP M20)")
    if config.mode == RenderMode.ADAPTIVE:
        from another_raytracer_tpu_torch.ops import adaptive

        return adaptive.render_adaptive(scene, cam, config)

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
