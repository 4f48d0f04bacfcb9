"""Wavefront path integrators (port of ``another_raytracer_tpu.ops.integrator``:
``_advance``, ``_bounce``, ``trace`` and the regenerating wavefront
``trace_regenerative``).

The reference's recursive ``_ray_color`` (engine.h:447-466) becomes a loop
over bounces carrying (origin, direction, time, throughput, radiance, alive)
for a whole ray batch, with termination as masks: a path contributes
``sum_k (prod_{j<k} attenuation_j) * emitted_k`` plus the background
weighted by the throughput at the miss bounce.  No russian roulette and no
light sampling, as in the reference.

``trace`` is the lockstep loop and the autograd path of the port (the JAX
package's ``differentiable=True`` ``lax.scan``): the closest-hit winner
search runs under ``torch.no_grad()`` (the JAX ``stop_gradient``), and only
the winner's hit record is recomputed with gradients, so geometry gradients
flow through the hit point while the [B, N] sweep keeps nothing for the
backward.

``trace_regenerative`` is the forward wavefront of every scene the
megakernel does not take (BVH scenes, noise / image / barycentric textures,
triangles): each lane re-arms with its next sample the moment its path
ends, and the alive lanes are compacted into narrower buffers as the tail
thins out.  Its bounces run the kernels K5 (BVH closest hit) and K4 (Perlin
noise) on CUDA tensors.

Left out on purpose (ROADMAP M21): the XLA schedule arguments ``remat`` and
``unroll``, the dead-lane parking ``_park_dead`` / ``DEAD_PARK`` and the
Mosaic tiling ``REGEN_COMPACT_ALIGN`` — results on dead lanes are masked
either way.  Media (M15) raise.
"""

from __future__ import annotations

import torch

from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import intersect, rng, shade, vec3
from another_raytracer_tpu_torch.ops.vec3 import V3

# Staged tail compaction of the regenerating wavefront (the JAX package's
# values): when the alive count drops to half the next stage's width, the
# survivors are gathered into a buffer REGEN_COMPACT_SHRINK times narrower,
# rounded up to a multiple of REGEN_COMPACT_ROUND lanes (whole warps and
# blocks on the card); no stage starts below REGEN_COMPACT_MIN_B lanes.
REGEN_COMPACT_MIN_B = 8192
REGEN_COMPACT_SHRINK = 8
REGEN_COMPACT_ROUND = 128


def check_supported(scene):
    """Raise NotImplementedError naming the ROADMAP item of anything in the
    scene the integrators cannot trace yet."""
    intersect.check_supported(scene)
    shade.check_supported(scene)


def _advance(scene, o, d, time, throughput, alive, pixel_ids, sample_ids,
             bounce, seed, t_min, fast_texel=False):
    """The bounce contract (engine.h:447-466): winner search, miss ->
    background, emission, branchless scatter.

    ``fast_texel`` (forward-only callers): textures may take kernels without
    a backward (Perlin, K4), and at widths of at least the ``FOLD_*_MIN_B``
    gates the BVH kernel folds the winner's record (intersect.py).

    Returns (radiance_delta V3, hit_p V3, new_dir V3, attenuation V3,
    scattered [B] bool = alive & hit & scatter_ok).
    """
    width = pixel_ids.shape[0]
    fold_tri = (scene.tri_in_bvh and intersect.FOLD_TRI_RECORD
                and width >= intersect.FOLD_RECORD_MIN_B)
    fold_sph = (scene.sph_in_bvh and intersect.FOLD_SPH_RECORD
                and scene.n_bvh_nodes == 0 and scene.sph_fold_safe
                and width >= intersect.FOLD_SPH_MIN_B)
    want_aux = fast_texel and (fold_tri or fold_sph)
    # Winner selection is a detached discrete decision (the JAX sg): the
    # backward sees only the per-ray winner recompute in make_hit_record.
    aux = None
    with torch.no_grad():
        hit_args = (scene, o.map(torch.Tensor.detach),
                    d.map(torch.Tensor.detach), time.detach(), t_min)
        if want_aux:
            (t, kind, idx), aux = intersect.closest_hit(*hit_args,
                                                        want_aux=True)
        else:
            t, kind, idx = intersect.closest_hit(*hit_args)
    hit = (kind >= 0) & alive

    # Miss -> background * throughput, then die (engine.h:455-457).
    miss_now = alive & ~hit
    zero = V3.zeros_like(t)
    delta = vec3.where(miss_now, throughput * V3.from_array(scene.background),
                       zero)

    rec = intersect.make_hit_record(scene, o, d, time, t, kind, idx, aux=aux)
    # Emission accumulates for every live hit (engine.h:460-465).
    emit, new_dir, attenuation, scatter_ok = shade.emit_and_scatter(
        scene, rec, d, pixel_ids, sample_ids, bounce, seed, fast_texel)
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
    count).  Forward renders go through the megakernel or
    ``trace_regenerative``; this is the path of the differentiable renders
    that the fused path does not take.
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


# --------------------------------------------------------------------------
# The regenerating forward wavefront
# --------------------------------------------------------------------------


def _regen_loop_parts(scene, cam, pix_ids, seed, width, height,
                      sample_stride, limit, max_depth, t_min):
    """(cam_rays, body) of the regenerating wavefront, bound to one
    lane -> pixel assignment; a compaction stage rebinds to the gathered
    survivors' pixels.  ``body`` maps the 10-tuple carry (o, d, time,
    throughput, total, path_rad, alive, sample, bounce, segments) to the
    next."""
    needs_time = scene.has_motion

    def cam_rays(sample_ids):
        return camera_lib.generate_rays(cam, pix_ids, sample_ids, width,
                                        height, seed, needs_time=needs_time)

    def body(state):
        (o, d, time, throughput, total, path_rad, alive, sample, bounce,
         segments) = state
        delta, hit_p, new_dir, attenuation, scattered = _advance(
            scene, o, d, time, throughput, alive, pix_ids, sample, bounce,
            seed, t_min, fast_texel=True)
        path_rad = path_rad + delta
        throughput = vec3.where(scattered, throughput * attenuation, throughput)
        o = vec3.where(scattered, hit_p, o)
        d = vec3.where(scattered, new_dir, d)
        bounce = torch.where(alive, bounce + 1, bounce)
        # Depth exhaustion contributes nothing further (engine.h:451-452).
        alive_next = scattered & (bounce < max_depth)
        # Count every scatter (even depth-capped ones), as the lockstep loop
        # does, so segment totals agree across the two.
        segments = segments + scattered.sum()

        # Fold finished paths into the lane total as one value: the add
        # grouping of the lockstep chunk loop (acc += whole-sample radiance).
        ended = alive & ~alive_next
        zeros = V3.zeros_like(total.x)
        total = total + vec3.where(ended, path_rad, zeros)
        path_rad = vec3.where(ended, zeros, path_rad)

        # Re-arm ended lanes with their next sample's primary ray.
        next_sample = torch.where(ended, (sample + sample_stride) & rng.MASK32,
                                  sample)
        regen = ended & (next_sample < limit)
        if bool(regen.any()):
            o2, d2, time2 = cam_rays(next_sample)
            o = vec3.where(regen, o2, o)
            d = vec3.where(regen, d2, d)
            time = torch.where(regen, time2, time)
            one = torch.ones_like(throughput.x)
            throughput = vec3.where(regen, V3(one, one, one), throughput)
            bounce = torch.where(regen, 0, bounce)
        alive_next = alive_next | regen
        segments = segments + regen.sum()
        return (o, d, time, throughput, total, path_rad, alive_next,
                next_sample, bounce, segments)

    return cam_rays, body


def _regen_initial_state(cam_rays, sample_ids0, limit):
    """Initial 10-tuple carry of the regenerating wavefront."""
    o, d, time = cam_rays(sample_ids0)
    z = d.x * 0.0
    ones = z + 1.0
    o = V3(o.x + z, o.y + z, o.z + z)
    time = time + z
    alive = sample_ids0 < limit
    return (o, d, time, V3(ones, ones, ones), V3(z, z, z), V3(z, z, z), alive,
            sample_ids0, torch.zeros_like(sample_ids0), alive.sum())


def _stage_widths(B: int) -> list:
    widths = [B]
    while widths[-1] >= REGEN_COMPACT_MIN_B:
        nxt = -(-widths[-1] // REGEN_COMPACT_SHRINK)
        nxt = -(-nxt // REGEN_COMPACT_ROUND) * REGEN_COMPACT_ROUND
        if nxt >= widths[-1]:
            break
        widths.append(nxt)
    return widths


def trace_regenerative(scene, cam, pixel_ids, sample_ids0, seed, *,
                       width: int, height: int, sample_stride: int,
                       sample_end, spp_cap, max_depth: int, t_min: float):
    """Forward-only wavefront with per-lane sample regeneration.

    Each lane owns a (pixel, sample progression) work list: lane ``i``
    traces samples ``sample_ids0[i]``, ``+ sample_stride``, ... below
    ``min(sample_end, spp_cap)``, re-arming with the next sample's camera ray
    the moment its path ends.  Radiance equals the lockstep path's bit for
    bit at ``sample_stride`` 1: each lane accumulates its samples in the same
    (sample, bounce) order with the same draws.

    Staged tail compaction: each stage runs while the alive count is above
    half the next stage's width; then the survivors (with their running
    totals) are gathered into the narrower buffer, and at the end every
    stage's totals are scattered back to the lanes they came from.

    ``pixel_ids`` / ``sample_ids0`` are int64 [B] tensors of uint32 values.
    Returns (radiance V3 [B] per-lane sums, segments int64 scalar tensor).
    Not differentiable: the loop's trip count depends on the data.
    """
    check_supported(scene)
    limit = min(int(sample_end), int(spp_cap), rng.MASK32)
    B = pixel_ids.shape[0]
    widths = _stage_widths(B)

    cam_rays, body = _regen_loop_parts(scene, cam, pixel_ids, seed, width,
                                       height, sample_stride, limit,
                                       max_depth, t_min)
    state = _regen_initial_state(cam_rays, sample_ids0 & rng.MASK32, limit)
    pix = pixel_ids
    backmaps = []  # (parent totals V3, survivor lane ids)
    for i in range(len(widths)):
        if i:
            _, body = _regen_loop_parts(scene, cam, pix, seed, width, height,
                                        sample_stride, limit, max_depth, t_min)
        if i + 1 < len(widths):
            cap = widths[i + 1]
            # The alive count only shrinks (a lane that has spent its samples
            # never re-arms), so it is <= cap // 2 on exit.
            while int(state[6].sum()) > cap // 2:
                state = body(state)
            (o, d, time, throughput, total, path_rad, alive, sample, bounce,
             segments) = state
            src = torch.nonzero(alive).squeeze(1)
            count = src.shape[0]
            padded = torch.cat([src, src.new_zeros(cap - count)])
            valid = torch.arange(cap, device=src.device) < count

            def take(a, padded=padded):
                return a.index_select(0, padded)

            zeros = V3.zeros_like(valid.to(total.x.dtype))
            state = (o.map(take), d.map(take), take(time),
                     throughput.map(take),
                     # Child totals continue the gathered lanes' running sums;
                     # the scatter-back replaces the parent's entries.
                     vec3.where(valid, total.map(take), zeros),
                     vec3.where(valid, path_rad.map(take), zeros),
                     valid, take(sample), take(bounce), segments)
            backmaps.append((total, src))
            pix = take(pix)
        else:
            while bool(state[6].any()):
                state = body(state)

    total, segments = state[4], state[9]
    for parent, src in reversed(backmaps):
        count = src.shape[0]
        total = V3(*(p.index_copy(0, src, c[:count])
                     for p, c in zip(parent, total)))
    return total, segments
