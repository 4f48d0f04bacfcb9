"""Lockstep wavefront path integrator (port of
``another_raytracer_tpu.ops.integrator``: ``_advance``, ``_bounce`` and
``trace``).

The reference's recursive ``_ray_color`` (engine.h:447-466) becomes a loop
over bounces carrying (origin, direction, time, throughput, radiance, alive)
for a whole ray batch, with termination as masks: a path contributes
``sum_k (prod_{j<k} attenuation_j) * emitted_k`` plus the background
weighted by the throughput at the miss bounce.  No russian roulette and no
light sampling, as in the reference.

The loop is the autograd path of the port (the JAX package's
``differentiable=True`` ``lax.scan``): the closest-hit winner search runs under
``torch.no_grad()`` (the JAX ``stop_gradient``), and only the winner's hit
record is recomputed with gradients, so geometry gradients flow through the
hit point while the [B, N] sweep keeps nothing for the backward.

Left out on purpose (ROADMAP M21): the XLA schedule arguments ``remat`` and
``unroll`` and the dead-lane parking ``_park_dead`` — results on dead lanes
are masked either way.  Media (M15) and BVH scenes (M16) raise.
"""

from __future__ import annotations

import torch

from another_raytracer_tpu_torch.ops import intersect, shade, vec3
from another_raytracer_tpu_torch.ops.vec3 import V3


def check_supported(scene):
    """Raise NotImplementedError naming the ROADMAP item of anything in the
    scene the lockstep integrator cannot trace yet."""
    intersect.check_supported(scene)
    shade.check_supported(scene)


def _advance(scene, o, d, time, throughput, alive, pixel_ids, sample_ids,
             bounce, seed, t_min):
    """The bounce contract (engine.h:447-466): winner search, miss ->
    background, emission, branchless scatter.

    Returns (radiance_delta V3, hit_p V3, new_dir V3, attenuation V3,
    scattered [B] bool = alive & hit & scatter_ok).
    """
    # Winner selection is a detached discrete decision (the JAX sg): the
    # backward sees only the per-ray winner recompute in make_hit_record.
    with torch.no_grad():
        t, kind, idx = intersect.closest_hit(
            scene, o.map(torch.Tensor.detach), d.map(torch.Tensor.detach),
            time.detach(), t_min)
    hit = (kind >= 0) & alive

    # Miss -> background * throughput, then die (engine.h:455-457).
    miss_now = alive & ~hit
    zero = V3.zeros_like(t)
    delta = vec3.where(miss_now, throughput * V3.from_array(scene.background),
                       zero)

    rec = intersect.make_hit_record(scene, o, d, time, t, kind, idx)
    # Emission accumulates for every live hit (engine.h:460-465).
    emit, new_dir, attenuation, scatter_ok = shade.emit_and_scatter(
        scene, rec, d, pixel_ids, sample_ids, bounce, seed)
    delta = delta + vec3.where(hit, throughput * emit, zero)
    return delta, rec.p, new_dir, attenuation, hit & scatter_ok


def _bounce(scene, carry, bounce, pixel_ids, sample_ids, seed, t_min):
    """One lockstep wavefront bounce; returns the updated carry."""
    o, d, time, throughput, radiance, alive, segments = carry
    delta, hit_p, new_dir, attenuation, scattered = _advance(
        scene, o, d, time, throughput, alive, pixel_ids, sample_ids, bounce,
        seed, t_min)
    radiance = radiance + delta
    alive = scattered
    throughput = vec3.where(alive, throughput * attenuation, throughput)
    o = vec3.where(alive, hit_p, o)
    d = vec3.where(alive, new_dir, d)
    segments = segments + alive.sum()
    return (o, d, time, throughput, radiance, alive, segments)


def trace(scene, o: V3, d: V3, time, pixel_ids, sample_ids, seed,
          max_depth: int, t_min: float):
    """Trace a ray batch through ``max_depth`` bounces (a fixed trip count,
    like the JAX scan), differentiable where autograd is enabled.

    ``pixel_ids`` / ``sample_ids`` are int64 [B] tensors of uint32 values
    (the RNG counters).  Returns (radiance V3 of [B], segments int64 scalar
    tensor — ray segments alive summed over bounces, the honest bounce-ray
    count).  The port's forward renders go through the megakernel; this is
    the path of the differentiable renders the fused path does not take.
    """
    check_supported(scene)
    z = d.x * 0.0
    ones = z + 1.0
    alive = torch.ones(z.shape, dtype=torch.bool, device=z.device)
    o = V3(o.x + z, o.y + z, o.z + z)
    carry = (o, d, time, V3(ones, ones, ones), V3(z, z, z), alive,
             alive.sum())
    for bounce in range(max_depth):
        carry = _bounce(scene, carry, bounce, pixel_ids, sample_ids, seed,
                        t_min)
    return carry[4], carry[6]
