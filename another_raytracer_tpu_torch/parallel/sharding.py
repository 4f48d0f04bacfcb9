"""Multi-device rendering over a device partition (port of
``another_raytracer_tpu.parallel.sharding``).

The reference's two data-parallel strategies over its 4-thread pool map
onto a (``tile`` x ``spp``) grid of devices, the counterpart of JAX's
``hybrid_mesh``:

  * ``parallel_stripes`` (engine.h:335-376): the pixels split into
    contiguous chunks of the Morton order over ``tile``; each shard traces
    its pixels at full spp;
  * ``parallel_images`` (engine.h:378-445): the sample range split over
    ``spp``; the linear partial sums are added in shard order (float32, the
    counterpart of ``psum``) before one gamma (write_color_raw, then one
    write_color, engine.h:401,437).

A partition's shards run one after another from the host; each device's
launches are asynchronous, so shards on distinct cards overlap.  A device
may repeat (``[cuda:0] * 4`` is a 4-way split on one card, ``[cpu] * 8``
the CPU tests' 8 shards), and a repeated device shares one copy of the
scene.  The RNG keys on absolute (pixel, sample) ids, so stripes give the
single-mode radiance bit for bit, and images give it up to the order of
the float additions.

Where the pixels do not divide over ``tile``, the last chunks are short or
empty: a short chunk is traced as it is and an empty one not at all, so
the segments equal single mode's at every size, and each tile shard of a
differentiable render keeps the fused path, which takes any lane count.
(The JAX package pads by repeating the first pixels, whose lanes are
traced again and counted.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.ops import color as color_lib
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.ops.vec3 import V3


@dataclasses.dataclass(frozen=True)
class Partition:
    """A (tile x spp) grid of torch devices: ``devices[t][k]`` traces the
    pixel chunk t at the sample range k."""

    devices: tuple

    @property
    def n_tile(self) -> int:
        return len(self.devices)

    @property
    def n_spp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "spp": self.n_spp}


def hybrid_partition(n_tile: int = None, n_spp: int = None,
                     devices=None) -> Partition:
    """A (tile x spp) partition of ``devices`` (default: every visible CUDA
    device), taken in order.  With neither count given, every device is on
    ``tile`` (stripes)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is visible; pass the devices "
                               "of the partition")
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if n_tile is None and n_spp is None:
        n_tile, n_spp = n, 1
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    if n_tile < 1 or n_spp < 1 or n_tile * n_spp > n:
        raise ValueError(f"a {n_tile} x {n_spp} partition needs "
                         f"{max(n_tile, 1) * max(n_spp, 1)} devices, got {n}")
    return Partition(tuple(tuple(devices[t * n_spp:(t + 1) * n_spp])
                           for t in range(n_tile)))


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device's index, which the scene's
    tensors report."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def stripe(n: int, index: int, count: int) -> tuple:
    """[lo, hi) of contiguous chunk ``index`` of ``count`` over n items: all
    chunks ceil(n / count) long but the last ones, which may be short or
    empty."""
    size = -(-n // count)
    return min(index * size, n), min((index + 1) * size, n)


def radiance_pixels(scene, cam, pixel_ids, seed, *, partition: Partition,
                    width, height, spp, samples_per_pass, max_depth, t_min,
                    differentiable=False, trainable=None):
    """Radiance sums of a pixel batch at full spp over ``partition``: the
    pixels in contiguous chunks over ``tile`` (a short chunk traced as it
    is, an empty one skipped), shard k on ``spp`` tracing samples
    [k*ceil(spp/n_spp), (k+1)*...) ∩ [0, spp), each shard one
    ``render.radiance_batch`` call.

    Returns (radiance_sum V3 of [Np] on the scene's device, segments int64
    scalar tensor), differentiable where ``differentiable`` is."""
    if not isinstance(partition, Partition):
        raise TypeError(f"partition must be a Partition, got "
                        f"{type(partition).__name__}")
    out_dev = scene.device
    n = pixel_ids.shape[0]
    spp_local = -(-spp // partition.n_spp)
    placed = {}

    def on(dev):
        """The scene and camera on ``dev``, one copy per device."""
        if dev not in placed:
            placed[dev] = ((scene, cam) if dev == out_dev
                           else (scene.to(dev), cam.to(dev)))
        return placed[dev]

    tiles = []
    segments = torch.zeros((), dtype=torch.int64, device=out_dev)
    for t, row in enumerate(partition.devices):
        lo, hi = stripe(n, t, partition.n_tile)
        if hi == lo:
            continue
        ids = pixel_ids[lo:hi]
        acc = None
        for k, dev in enumerate(row):
            s, c = on(dev)
            part, segs = render_lib.radiance_batch(
                s, c, ids.to(dev), seed, width=width, height=height,
                sample_start=k * spp_local, n_samples=spp_local, spp_cap=spp,
                samples_per_pass=samples_per_pass, max_depth=max_depth,
                t_min=t_min, differentiable=differentiable,
                trainable=trainable)
            part = torch.stack(tuple(part), dim=1).to(out_dev)
            acc = part if acc is None else acc + part
            segments = segments + segs.to(out_dev)
        tiles.append(acc)
    acc = (torch.cat(tiles) if tiles
           else torch.zeros((0, 3), dtype=torch.float32, device=out_dev))
    return V3(acc[:, 0], acc[:, 1], acc[:, 2]), segments


def render_radiance_sharded(scene, cam, seed, *, partition: Partition, width,
                            height, spp, samples_per_pass, max_depth, t_min,
                            differentiable=False, trainable=None):
    """Per-pixel radiance sums of the whole frame over ``partition``, the
    pixels in Morton order (JAX: sharding.py:84-87).  With a (N, 1)
    partition this is parallel_stripes, with (1, N) parallel_images.

    Returns (radiance_sum V3 of [H*W] in scanline order, segments)."""
    order, inv = render_lib.morton_order(width, height)
    dev = scene.device
    acc, segments = radiance_pixels(
        scene, cam, torch.from_numpy(order.astype(np.int64)).to(dev), seed,
        partition=partition, width=width, height=height, spp=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
        differentiable=differentiable, trainable=trainable)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
    return acc.map(lambda c: c.index_select(0, inv_t)), segments


def default_partition(mode: RenderMode, devices=None) -> Partition:
    """Every device on ``tile`` for stripes, on ``spp`` for images."""
    if mode == RenderMode.PARALLEL_IMAGES:
        return hybrid_partition(n_tile=1, devices=devices)
    return hybrid_partition(n_spp=1, devices=devices)


def render_sharded(scene, cam, config: RenderConfig,
                   partition: Partition = None):
    """A parallel-mode render -> (uint8 image [H, W, 3] on the host, stats
    with 'segments' and 'partition').  The default partition is the
    mode's over every visible CUDA device."""
    if partition is None:
        partition = default_partition(config.mode)
    acc, segments = render_radiance_sharded(
        scene, cam, config.seed, partition=partition, width=config.width,
        height=config.height, spp=config.samples_per_pixel,
        samples_per_pass=config.samples_per_pass, max_depth=config.max_depth,
        t_min=config.t_min)
    img = color_lib.to_uint8(torch.stack(tuple(acc), dim=-1),
                             config.samples_per_pixel)
    img = img.cpu().numpy().reshape(config.height, config.width, 3)
    return img, {"segments": int(segments), "partition": partition.shape}
