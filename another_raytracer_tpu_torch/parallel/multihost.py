"""Rendering across processes on ``torch.distributed`` (port of
``another_raytracer_tpu.parallel.multihost``).

Each process (rank) renders its stripes — contiguous chunk ``rank`` of
``world_size`` of the Morton pixel order, over its own partition
(``parallel/sharding.py``) — and ``host_local_image`` gathers every rank's
stripes into the full frame on every rank.

    from another_raytracer_tpu_torch.parallel import multihost
    multihost.initialize("nccl", "tcp://host0:29500", world_size=2, rank=r)
    radiance, segments = multihost.render_radiance_multihost(scene, cam, ...)
    if multihost.is_primary(): ...write the image...

The backend is always the caller's: ``nccl`` for one card per rank,
``gloo`` for the CPU and for ranks that share a card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.parallel import sharding

BACKENDS = ("nccl", "gloo")


def initialize(backend: str, init_method: str = None, world_size: int = None,
               rank: int = None):
    """``torch.distributed.init_process_group`` with the environment's
    fallback: without ``init_method``, ``env://`` (MASTER_ADDR,
    MASTER_PORT), and without ``world_size`` / ``rank``, WORLD_SIZE / RANK.
    A repeated call is a no-op; every other failure raises — quietly going
    on in one process would render 1/N of the frame.  Returns (rank,
    world size)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_world():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def render_radiance_multihost(scene, cam, seed, *, width, height, spp,
                              samples_per_pass, max_depth, t_min,
                              partition=None):
    """This rank's stripes over ``partition`` (default: the scene's device
    alone), gathered from every rank into the whole frame.  Returns
    (radiance_sum [H*W, 3] float32 numpy in scanline order, segments of
    every rank) on every rank."""
    rank, world = _rank_world()
    order, inv = render_lib.morton_order(width, height)
    lo, hi = sharding.stripe(order.shape[0], rank, world)
    dev = scene.device
    if partition is None:
        partition = sharding.hybrid_partition(devices=[dev])
    acc, segments = sharding.radiance_pixels(
        scene, cam, torch.from_numpy(order[lo:hi].astype(np.int64)).to(dev),
        seed, partition=partition, width=width, height=height, spp=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min)
    local = torch.stack(tuple(acc), dim=1)
    frame, segments = host_local_image(local, segments, order.shape[0])
    return frame[inv], segments


def host_local_image(local, segments, n_pixels):
    """Gather every rank's stripes ([chunk, 3], chunk ``rank`` of the
    pixel order) into the [n_pixels, 3] frame on every rank (numpy, in the
    stripes' order), and sum the ranks' segments."""
    _, world = _rank_world()
    if world == 1:
        return local.detach().cpu().numpy(), int(segments)
    # nccl gathers CUDA tensors, gloo host tensors.
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    size = -(-n_pixels // world)
    padded = torch.zeros((size, 3), dtype=torch.float32, device=dev)
    padded[:local.shape[0]] = local.detach().to(dev)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    segs = segments.detach().to(dev, torch.int64).reshape(1)
    dist.all_reduce(segs)
    frame = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(
        parts, (sharding.stripe(n_pixels, r, world) for r in range(world)))])
    return frame.cpu().numpy(), int(segs)
