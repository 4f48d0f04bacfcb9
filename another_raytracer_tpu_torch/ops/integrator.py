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
triangles, media): each lane re-arms with its next sample the moment its path
ends, and the alive lanes are compacted into narrower buffers as the tail
thins out.  On CUDA tensors each step is K5 (BVH closest hit) over the
scene's trees and one launch of the bounce kernel for everything after,
the re-arm included (``_kernel_step_parts``); the CPU runs the eager step
(``_eager_step_parts``, ``_advance``'s tensor ops) and then, where a lane
re-arms, the re-arm's, whose bits the kernel's equal.  On the card it
replays each stage's loop body from a CUDA graph (``_Stage``; the host's
launches an iteration become one graph launch), captured once a key per
stage width.

Left out on purpose (ROADMAP M21): the XLA schedule arguments ``remat`` and
``unroll``, the dead-lane parking ``_park_dead`` / ``DEAD_PARK`` and the
Mosaic tiling ``REGEN_COMPACT_ALIGN`` — results on dead lanes are masked
either way.
"""

from __future__ import annotations

import collections

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import intersect, kernels, rng, shade, vec3
from another_raytracer_tpu_torch.ops.vec3 import V3
from another_raytracer_tpu_torch.utils import profiling

# Staged tail compaction of the regenerating wavefront (the JAX package's
# values): when the alive count drops to half the next stage's width, the
# survivors are gathered into a buffer REGEN_COMPACT_SHRINK times narrower,
# rounded up to a multiple of REGEN_COMPACT_ROUND lanes (whole warps and
# blocks on the card); no stage starts below REGEN_COMPACT_MIN_B lanes.
REGEN_COMPACT_MIN_B = 8192
REGEN_COMPACT_SHRINK = 8
REGEN_COMPACT_ROUND = 128

# The regenerating wavefront's device counts (``trace_regenerative``'s
# ``counts``), in the order of the step parts' last arguments, which take
# them: the live lanes whose winner is a sphere, and those whose winner is
# a medium (each a scatter in it), by the scene's field that counts that
# kind; a scene without the kind runs no op for its count.
COUNTED = (("sphere_hits", "n_spheres"), ("medium_scatters", "n_media"))


def _counters(scene, device) -> dict:
    """{name: a 0-d int64 zero on ``device``} of each count of ``COUNTED``
    whose kind ``scene`` has."""
    return {name: torch.zeros((), dtype=torch.int64, device=device)
            for name, kind in COUNTED if getattr(scene, kind)}


def _count_args(counters) -> list:
    """``counters``' tensors in ``COUNTED``'s order, None for a count it
    lacks: the step parts' last arguments."""
    return [counters.get(name) for name, _ in COUNTED]


def media_uniforms(scene, pixel_ids, sample_ids, bounce, seed):
    """One uniform per (ray, medium) for the free flights, [B, Nm]: lanes
    DIM_MEDIUM + 2*m keep media draws independent of every other draw.  A
    function of (pixel, sample, bounce), so the wavefront's compaction
    carries nothing for it."""
    cols = [rng.uniform2(seed, pixel_ids, sample_ids, bounce,
                         rng.DIM_MEDIUM + 2 * m)[0]
            for m in range(scene.n_media)]
    if not cols:
        return torch.zeros((pixel_ids.shape[0], 0), dtype=torch.float32,
                           device=pixel_ids.device)
    return torch.stack(cols, dim=-1)


def _advance(scene, o, d, time, throughput, alive, pixel_ids, sample_ids,
             bounce, seed, t_min, fast_texel=False, sphere_hits=None,
             medium_scatters=None):
    """The bounce contract (engine.h:447-466): winner search, miss ->
    background, emission, branchless scatter.

    ``fast_texel`` (forward-only callers): textures may take kernels without
    a backward (Perlin, K4), and the BVH kernel folds the winner's record of
    the tree ``intersect.fold_tree`` names at this width.
    ``sphere_hits``: a 0-d int64 tensor that the live lanes whose winner is
    a sphere are added into, in place, on the device; ``medium_scatters``
    the same for a medium (each such lane scatters in the medium).

    Returns (radiance_delta V3, hit_p V3, new_dir V3, attenuation V3,
    scattered [B] bool = alive & hit & scatter_ok).
    """
    fold = (intersect.fold_tree(scene, pixel_ids.shape[0]) if fast_texel
            else None)
    u_media = media_uniforms(scene, pixel_ids, sample_ids, bounce, seed)
    # Winner selection is a detached discrete decision (the JAX sg): the
    # backward sees only the per-ray winner recompute in make_hit_record.
    aux = None
    with torch.no_grad():
        hit_args = (scene, o.map(torch.Tensor.detach),
                    d.map(torch.Tensor.detach), time.detach(), u_media,
                    t_min)
        if fold:
            (t, kind, idx), aux = intersect.closest_hit(*hit_args, fold=fold)
        else:
            t, kind, idx = intersect.closest_hit(*hit_args)
    hit = (kind >= 0) & alive
    if sphere_hits is not None:
        sphere_hits.add_((hit & (kind == scene_lib.PRIM_SPHERE)).sum())
    if medium_scatters is not None:
        medium_scatters.add_((hit & (kind == scene_lib.PRIM_MEDIUM)).sum())

    # Miss -> background * throughput, then die (engine.h:455-457).
    miss_now = alive & ~hit
    zero = V3.zeros_like(t)
    delta = vec3.where(miss_now, throughput * V3.from_array(scene.background),
                       zero)

    rec = intersect.make_hit_record(scene, o, d, time, t, kind, idx, u_media,
                                    t_min=t_min, aux=aux)
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


def _regen_step_parts(scene, cam, pix_ids, seed, width, height,
                      sample_stride, limit, max_depth, t_min,
                      sphere_hits=None, medium_scatters=None):
    """(cam_rays, step, rearm) of the regenerating wavefront, bound to one
    lane -> pixel assignment.  ``step(carry, into=None)`` maps the 10-tuple
    carry (o, d, time, throughput, total, path_rad, alive, sample, bounce,
    segments) to (the carry with the ended lanes' next samples and the
    re-armed lanes alive, ``regen``: the lanes to re-arm, ``any_regen``: a
    0-d tensor, true where one does), adding its sphere winners into
    ``sphere_hits`` and its medium winners into ``medium_scatters`` where
    given; ``into``, where given, is a carry of buffers that the step may
    write into (the stage's, in place).
    ``rearm(carry, regen)`` gives those lanes their next sample's primary
    ray.  A step with ``step.rearms`` gives them their rays itself: its
    ``regen`` and ``any_regen`` are None, ``rearm`` is None, and the loop
    reads nothing after it.  ``seed`` is an int or a 0-d int64 tensor (the
    same bits); ``step.kind`` names the step's path.

    CUDA lanes step through K5 and the bounce kernel, which re-arms
    (``_kernel_step_parts``); every other device runs the eager step
    (``_eager_step_parts``), whose re-arm is a step of its own, the
    kernel's plain version."""
    parts = _kernel_step_parts if pix_ids.is_cuda else _eager_step_parts
    return parts(scene, cam, pix_ids, seed, width, height, sample_stride,
                 limit, max_depth, t_min, sphere_hits, medium_scatters)


def _cam_rearm(scene, cam, pix_ids, seed, width, height):
    """(cam_rays, rearm) of ``_regen_step_parts``."""
    needs_time = scene.has_motion

    def cam_rays(sample_ids):
        return camera_lib.generate_rays(cam, pix_ids, sample_ids, width,
                                        height, seed, needs_time=needs_time)

    def rearm(state, regen):
        (o, d, time, throughput, total, path_rad, alive, sample, bounce,
         segments) = state
        o2, d2, time2 = cam_rays(sample)
        o = vec3.where(regen, o2, o)
        d = vec3.where(regen, d2, d)
        time = torch.where(regen, time2, time)
        one = torch.ones_like(throughput.x)
        throughput = vec3.where(regen, V3(one, one, one), throughput)
        bounce = torch.where(regen, 0, bounce)
        return (o, d, time, throughput, total, path_rad, alive, sample, bounce,
                segments)

    return cam_rays, rearm


def _eager_step_parts(scene, cam, pix_ids, seed, width, height,
                      sample_stride, limit, max_depth, t_min,
                      sphere_hits=None, medium_scatters=None):
    """``_regen_step_parts`` as tensor ops (``_advance``), on any device:
    the bounce kernel's plain version."""
    cam_rays, rearm = _cam_rearm(scene, cam, pix_ids, seed, width, height)

    def step(state, into=None):
        (o, d, time, throughput, total, path_rad, alive, sample, bounce,
         segments) = state
        delta, hit_p, new_dir, attenuation, scattered = _advance(
            scene, o, d, time, throughput, alive, pix_ids, sample, bounce,
            seed, t_min, fast_texel=True, sphere_hits=sphere_hits,
            medium_scatters=medium_scatters)
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

        # Ended lanes with samples left re-arm with their next sample.
        next_sample = torch.where(ended, (sample + sample_stride) & rng.MASK32,
                                  sample)
        regen = ended & (next_sample < limit)
        alive_next = alive_next | regen
        segments = segments + regen.sum()
        return (o, d, time, throughput, total, path_rad, alive_next,
                next_sample, bounce, segments), regen, regen.any()

    step.kind, step.rearms = "eager", False
    return cam_rays, step, rearm


def _kernel_step_parts(scene, cam, pix_ids, seed, width, height,
                       sample_stride, limit, max_depth, t_min,
                       sphere_hits=None, medium_scatters=None):
    """``_regen_step_parts`` on CUDA lanes: K5 over the scene's trees
    (``intersect.tree_winners``), then one launch of the bounce kernel
    (``ops/kernels/bounce_kernel.py``) for everything after, the re-arm
    included, which writes the carry into ``into`` where given.  K5's first
    inputs are buffers made here, outside any capture, and the camera's
    launch arguments are read off the card here, once."""
    from another_raytracer_tpu_torch.ops.kernels import bounce_kernel

    cam_rays, _ = _cam_rearm(scene, cam, pix_ids, seed, width, height)
    B, dev = pix_ids.shape[0], pix_ids.device
    fold = intersect.fold_tree(scene, B)
    camera = bounce_kernel.camera_fields(cam, width, height,
                                         scene.has_motion)
    init = (torch.full((B,), intersect.BIG, dtype=torch.float32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev))

    def step(state, into=None):
        o, d, time = state[:3]
        winners = intersect.tree_winners(scene, o, d, time, t_min, fold, init)
        new = bounce_kernel.launch(
            scene, state, pix_ids, seed, winners, fold=fold, camera=camera,
            sample_stride=sample_stride, limit=limit, max_depth=max_depth,
            t_min=t_min, sphere_hits=sphere_hits,
            medium_scatters=medium_scatters, into=into)
        return new, None, None

    step.kind, step.rearms = "kernel", True
    return cam_rays, step, None


def _regen_loop_parts(scene, cam, pix_ids, seed, width, height,
                      sample_stride, limit, max_depth, t_min,
                      sphere_hits=None, medium_scatters=None):
    """(cam_rays, body) of the regenerating wavefront, bound to one
    lane -> pixel assignment; a compaction stage rebinds to the gathered
    survivors' pixels.  ``body`` maps the 10-tuple carry to the next: the
    ``step`` of ``_regen_step_parts``, then, unless the step re-arms, the
    host's read of whether any lane re-arms and the ``rearm`` where one
    does.  It counts on the span it runs in (the iteration's) how the lanes
    were re-armed, ``rearm``: ``kernel`` (the step did), ``ops`` (the
    re-arm ran) or ``none`` (the host read that no lane re-arms).
    ``body.step`` is the step's ``kind``."""
    cam_rays, step, rearm = _regen_step_parts(
        scene, cam, pix_ids, seed, width, height, sample_stride, limit,
        max_depth, t_min, sphere_hits, medium_scatters)

    def body(state):
        state, regen, any_regen = step(state)
        if step.rearms:
            profiling.count(rearm="kernel")
            return state
        with profiling.span("wavefront.wait", what="regen"):
            any_regen = bool(any_regen)
        profiling.count(rearm="ops" if any_regen else "none")
        if any_regen:
            state = rearm(state, regen)
        return state

    body.step = step.kind
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


def _compact(state, pix, cap, survivors):
    """Gather the ``survivors`` alive lanes of the carry ``state`` (and
    their pixels ``pix``) into a buffer of ``cap`` lanes.  Returns (state,
    pix, (the parent's totals, the survivors' lane ids)) for the
    scatter-back."""
    with profiling.span("wavefront.compact", survivors=survivors):
        (o, d, time, throughput, total, path_rad, alive, sample, bounce,
         segments) = state
        with profiling.span("wavefront.wait", what="compact"):
            src = torch.nonzero(alive).squeeze(1)
        count = src.shape[0]
        padded = torch.cat([src, src.new_zeros(cap - count)])
        valid = torch.arange(cap, device=src.device) < count

        def take(a):
            return a.index_select(0, padded)

        zeros = V3.zeros_like(valid.to(total.x.dtype))
        state = (o.map(take), d.map(take), take(time), throughput.map(take),
                 # Child totals continue the gathered lanes' running sums;
                 # the scatter-back replaces the parent's entries.
                 vec3.where(valid, total.map(take), zeros),
                 vec3.where(valid, path_rad.map(take), zeros),
                 valid, take(sample), take(bounce), segments)
        return state, take(pix), (total, src)


# --------------------------------------------------------------------------
# CUDA graphs of the loop body
# --------------------------------------------------------------------------


def _cuda_graphs(device):
    """A capture step over one fresh memory pool on ``device``:
    ``capture(fn)`` records ``fn``'s launches into a CUDA graph, on a side
    stream and without running them, and returns ``replay``, which launches
    the graph on the current stream and returns the tensors ``fn`` returned
    at capture (the graph writes them anew)."""
    pool = torch.cuda.graph_pool_handle()

    def capture(fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            main = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
            main.wait_stream(side)

        def replay():
            graph.replay()
            return out

        return replay

    return capture


# The capture step by device type (``_cuda_graphs``); a device type not
# named here runs the loop body eagerly, as the CPU does.
GRAPHS = {"cuda": _cuda_graphs}
# Stages whose graphs are kept, least recently used first out; an evicted
# stage frees its buffers and its graphs' memory pool.
GRAPH_CACHE_SIZE = 8
_stages = collections.OrderedDict()  # key -> _Stage


def _flatten(state) -> list:
    """The carry's 20 tensors (each V3 as its three)."""
    return [t for part in state
            for t in (part if isinstance(part, V3) else (part,))]


def _unflatten(flat) -> tuple:
    it = iter(flat)
    return tuple(V3(next(it), next(it), next(it)) if i in _V3_PARTS
                 else next(it) for i in range(10))


_V3_PARTS = (0, 1, 3, 4, 5)  # o, d, throughput, total, path_rad


def _copy_into(dst, src) -> None:
    """Copy each tensor of ``src`` into the buffer at its place in ``dst``,
    one foreach copy a dtype, leaving out those that are the buffer."""
    groups = {}
    for b, t in zip(dst, src):
        if b is not t:
            pair = groups.setdefault(b.dtype, ([], []))
            pair[0].append(b)
            pair[1].append(t)
    for bufs, ts in groups.values():
        torch._foreach_copy_(bufs, ts)


def _counted(capture, fn):
    """``capture(fn)``'s replay, which adds the launches its graph holds to
    the kernels' counts (``kernels.COUNTS``): a wrapper counts its launch
    when it runs, once at capture, when nothing reaches the card, and not on
    a replay.  ``held``: those launches, as ``kernels.launch_counts`` gives
    them."""
    before = kernels.COUNTS.copy()
    replay = capture(fn)
    graph = kernels.COUNTS - before
    kernels.COUNTS.clear()
    kernels.COUNTS.update(before)

    def counted():
        out = replay()
        kernels.COUNTS.update(graph)
        return out

    counted.held = kernels.launch_counts(graph)
    return counted


class _Stage:
    """One compaction stage's graphs and the buffers they read and write,
    for one key (``_stage``).  The carry, the stage's pixels and the seed
    live in the buffers; graph A (``step``) is the step, which writes the
    carry back in place (the bounce kernel writes it there itself).  A step
    that re-arms (the bounce kernel's, on the card) is the whole loop body;
    after any other, the body reads the re-arm flag and graph B (``rearm``)
    is the re-arm, which writes the carry back likewise.  Graph A also adds
    the scene's counts (``COUNTED``) into ``counters``, which ``load``
    zeroes.  The key's first iteration runs eagerly (``ran``); its second
    captures the graphs, and every later one replays them."""

    def __init__(self, device, parts_args):
        self.device = device
        self.parts_args = parts_args  # (scene, cam, width, ..., t_min)
        self.ran = 0
        self.bufs = self.seed = self.counters = self.capture = None
        self.step = self.rearm = self.regen = self._step = self._rearm = None

    @property
    def mode(self) -> str:
        if self.step is not None:
            return "replay"
        return "capture" if self.ran else "eager"

    def load(self, state, pix, seed):
        """Copy the carry and the pixels into the buffers and the render's
        seed into its own; returns the carry of buffers."""
        flat = _flatten(state) + [pix]
        if self.bufs is None:
            self.bufs = [torch.empty_like(t) for t in flat]
            self.seed = torch.empty((), dtype=torch.int64, device=self.device)
            self.counters = _counters(self.parts_args[0], self.device)
        _copy_into(self.bufs, flat)
        self.seed.fill_(seed)
        for count in self.counters.values():
            count.zero_()
        return _unflatten(self.bufs[:-1])

    def iterate(self):
        """One iteration of the loop body over the buffers: replay A, and
        unless its step re-arms, read whether any lane re-arms and replay B
        where one does; counts ``rearm`` as the body does."""
        state = _unflatten(self.bufs[:-1])
        if self.step is None:
            self._capture(state)
        self.regen, any_regen = self.step()
        if self._step.rearms:
            profiling.count(rearm="kernel")
            return state
        if self.rearm is None:
            self._capture_rearm(state)
        with profiling.span("wavefront.wait", what="regen"):
            any_regen = bool(any_regen)
        profiling.count(rearm="ops" if any_regen else "none")
        if any_regen:
            self.rearm()
        return state

    def _capture(self, state):
        scene, cam, *rest = self.parts_args
        self.capture = GRAPHS[self.device.type](self.device)
        # The stage keeps the parts: the graphs read buffers they hold.
        _, self._step, self._rearm = _regen_step_parts(
            scene, cam, self.bufs[-1], self.seed, *rest,
            *_count_args(self.counters))

        def run_step():
            new, regen, any_regen = self._step(state, into=state)
            _copy_into(self.bufs, _flatten(new))
            return regen, any_regen

        with profiling.span("wavefront.capture", what="step"):
            self.step = _counted(self.capture, run_step)

    def _capture_rearm(self, state):
        def run_rearm():
            _copy_into(self.bufs, _flatten(self._rearm(state, self.regen)))

        with profiling.span("wavefront.capture", what="rearm"):
            self.rearm = _counted(self.capture, run_rearm)


def _stage(device, stage_width, parts_args):
    """The stage of ``stage_width`` lanes for the loop parts' arguments
    (scene and camera by identity) and the tree whose record K5 folds at
    that width (``intersect.fold_tree``: a graph keeps the variant it
    captured), or None on a device without a capture step.  The least
    recently used stage past ``GRAPH_CACHE_SIZE`` goes."""
    if device.type not in GRAPHS:
        return None
    scene, cam, *fixed = parts_args
    key = (id(scene), id(cam), device, stage_width, *fixed,
           intersect.fold_tree(scene, stage_width))
    stage = _stages.get(key)
    if stage is None:
        # The stage holds the scene and camera, so their ids stay theirs.
        stage = _stages[key] = _Stage(device, parts_args)
        while len(_stages) > GRAPH_CACHE_SIZE:
            _stages.popitem(last=False)
    else:
        _stages.move_to_end(key)
    return stage


def trace_regenerative(scene, cam, pixel_ids, sample_ids0, seed, *,
                       width: int, height: int, sample_stride: int,
                       sample_end, spp_cap, max_depth: int, t_min: float,
                       counts=None):
    """Forward-only wavefront with per-lane sample regeneration.

    Each lane owns a (pixel, sample progression) work list: lane ``i``
    traces samples ``sample_ids0[i]``, ``+ sample_stride``, ... below
    ``min(sample_end, spp_cap)``, re-arming with the next sample's camera ray
    the moment its path ends.  Radiance equals the lockstep path's bit for
    bit at ``sample_stride`` 1: each lane accumulates its samples in the same
    (sample, bounce) order with the same draws.

    Staged tail compaction: each stage runs while the alive count is above
    half the next stage's width (the last stage while any lane is alive);
    then the survivors (with their running totals) are gathered into the
    narrower buffer, and at the end every stage's totals are scattered back
    to the lanes they came from.  The alive count is the one read of the
    card a loop step makes besides ``body``'s own, where it has one.

    CUDA graphs: on a device that ``GRAPHS`` names, each stage's loop body
    is replayed from CUDA graphs (``_Stage``) once its key (scene and
    camera, the fixed arguments, the stage's width, its fold) has run
    one iteration eagerly, so the host issues one graph launch (K5's and
    the bounce kernel's launches) and one read, the alive count, an
    iteration on the card; after a step that does not re-arm (the eager
    one), a second read and graph B (the re-arm's ~40 ops).  The ops are
    the eager body's, so images and segments are the same bits; a stage of
    one iteration never captures.  Fixed widths replay across renders
    (single, shards, progressive passes); data-dependent widths (adaptive
    levels) capture once a level.

    ``pixel_ids`` / ``sample_ids0`` are int64 [B] tensors of uint32 values.
    Returns (radiance V3 [B] per-lane sums, segments int64 scalar tensor).
    On a scene with spheres the loop also counts the live lanes whose
    winner is a sphere, and on one with media those whose winner is a
    medium, each a scatter in it, on the device (graphs and eager alike);
    ``counts`` (a dict, optional) then receives each count under its name
    in ``COUNTED``, ``"sphere_hits"`` and ``"medium_scatters"`` (int64
    scalar tensors).  A scene without the kind runs no op for its count.
    Not differentiable: the loop's trip count depends on the data.
    """
    limit = min(int(sample_end), int(spp_cap), rng.MASK32)
    B = pixel_ids.shape[0]
    widths = _stage_widths(B)
    parts_args = (scene, cam, width, height, sample_stride, limit, max_depth,
                  t_min)
    counters = _counters(scene, pixel_ids.device)
    with profiling.span("wavefront", lanes=B, stages=len(widths)):
        cam_rays, body = _regen_loop_parts(scene, cam, pixel_ids, seed,
                                           *parts_args[2:],
                                           *_count_args(counters))
        state = _regen_initial_state(cam_rays, sample_ids0 & rng.MASK32,
                                     limit)
        pix = pixel_ids
        backmaps = []  # (parent totals V3, survivor lane ids)
        for i, stage_width in enumerate(widths):
            stage = _stage(pixel_ids.device, stage_width, parts_args)
            if i:
                state, pix, backmap = _compact(state, pix, stage_width,
                                               alive_count)
                backmaps.append(backmap)
                _, body = _regen_loop_parts(scene, cam, pix, seed,
                                            *parts_args[2:],
                                            *_count_args(counters))
            in_bufs = False  # the carry lives in the stage's graph buffers
            # The alive count only shrinks (a lane that has spent its
            # samples never re-arms), so it is <= the floor on exit.
            floor = widths[i + 1] // 2 if i + 1 < len(widths) else 0
            while True:
                with profiling.span("wavefront.wait", what="alive"):
                    alive_count = int(state[6].sum())
                if alive_count <= floor:
                    break
                mode = "eager" if stage is None else stage.mode
                with profiling.span("wavefront.iteration", width=stage_width,
                                    alive=alive_count, graph=mode,
                                    step=getattr(body, "step", "eager")):
                    if mode == "eager":
                        state = body(state)
                        if stage is not None:
                            stage.ran += 1
                    else:
                        if not in_bufs:
                            state = stage.load(state, pix, seed)
                            in_bufs = True
                        state = stage.iterate()
            if in_bufs:
                for name, count in counters.items():
                    count.add_(stage.counters[name])

        total, segments = state[4], state[9]
        if in_bufs:  # nothing returned may alias a graph's buffer
            segments = segments.clone()
            if not backmaps:
                total = total.map(torch.clone)
        for parent, src in reversed(backmaps):
            count = src.shape[0]
            total = V3(*(p.index_copy(0, src, c[:count])
                         for p, c in zip(parent, total)))
    if counts is not None:
        counts.update(counters)
    return total, segments
