"""Scaling efficiency: Cornell forward throughput over 1, 2, 4 ... N devices
(the counterpart of the JAX package's ``scripts/scaling_harness.py``).

BASELINE.md's north star asks for >= 80% rays/s scaling efficiency.  The
harness renders the Cornell box forward (honest segments, bounces
included) over ``parallel/sharding.hybrid_partition(k, 1)`` of the first k
devices (stripes), for k = 1, 2, 4 ... N and N itself, and prints each
rate's efficiency against k times the one-device rate.

One host (every visible CUDA device by default; ``--devices`` names them,
and may repeat one; ``--cpu N`` takes N shards of the CPU):

    python -m another_raytracer_tpu_torch.scaling_harness [--devices LIST]
        [--cpu N] [--width 360 --height 270 --spp 16 --depth 8 --spass 1
        --reps 3]

Several processes (one per host; each renders its stripes over its own
devices through ``parallel/multihost.py`` and gathers the frame, over nccl
on cards and gloo on the CPU):

    python -m another_raytracer_tpu_torch.scaling_harness
        --coordinator HOST0:PORT --nprocs N --pid I

They measure only the whole set of processes; compare with a recorded
one-host run of the same workload.  Where the devices repeat
(``--devices cuda:0,cuda:0,cuda:0,cuda:0`` on one card), the shards run
one after another on that device: the harness then tests the partition
code, not scaling, and says so.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.parallel import multihost, sharding

SEED, T_MIN = 0, 1e-3


def sizes(n: int) -> list:
    """1, 2, 4 ... up to n, and n itself."""
    out, k = [], 1
    while k <= n:
        out.append(k)
        k *= 2
    if out[-1] != n:
        out.append(n)
    return out


def _sync(devices):
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure(render, devices, reps):
    """Time ``render()`` -> (radiance, segments) after one warm call: (the
    last call's radiance and segments, seconds a call, mean of reps)."""
    out = render()
    _sync(devices)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = render()
    _sync(devices)
    return out, (time.perf_counter() - t0) / reps


def render_fn(scene, cam, args, partition):
    """The Cornell render over ``partition``: () -> (radiance V3 of [H*W],
    segments)."""
    kw = dict(width=args.width, height=args.height, spp=args.spp,
              samples_per_pass=args.spass, max_depth=args.depth, t_min=T_MIN)
    return lambda: sharding.render_radiance_sharded(
        scene, cam, SEED, partition=partition, **kw)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="N shards of the CPU (0: the CUDA devices)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated torch devices (default every "
                         "visible CUDA device)")
    ap.add_argument("--width", type=int, default=360)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--spass", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    return ap.parse_args(argv)


def devices_of(args) -> list:
    if args.devices:
        return [torch.device(d) for d in args.devices.split(",")]
    if args.cpu:
        return [torch.device("cpu")] * args.cpu
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible (use --cpu N for N "
                           "shards of the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def main(argv=None) -> int:
    args = parse_args(argv)
    devices = devices_of(args)
    if args.coordinator:
        backend = "gloo" if devices[0].type == "cpu" else "nccl"
        multihost.initialize(backend, f"tcp://{args.coordinator}",
                             args.nprocs, args.pid)
    world = (torch.distributed.get_world_size()
             if args.coordinator else 1)
    partition = sharding.hybrid_partition(devices=devices)
    dev = partition.devices[0][0]
    scene, cam_params = library.cornell_box(device=dev)
    cam = camera_lib.make_camera(aspect_ratio=args.width / args.height,
                                 device=dev, **cam_params)
    n = len(devices)
    print(f"backend={dev.type} processes={world} "
          f"global_devices={n * world}")
    print(f"workload: cornell {args.width}x{args.height} spp={args.spp} "
          f"depth={args.depth}")
    if len(set(devices)) < n:
        print(f"devices repeat ({', '.join(map(str, devices))}): their "
              "shards run one after another, so this tests the partition "
              "code, not scaling")

    if args.coordinator:
        def render():
            return multihost.render_radiance_multihost(
                scene, cam, SEED, width=args.width, height=args.height,
                spp=args.spp, samples_per_pass=args.spass,
                max_depth=args.depth, t_min=T_MIN, partition=partition)
        (_, segments), dt = measure(render, devices, args.reps)
        rate = int(segments) / dt / 1e6
        print(f"devices={n * world} (x{world} processes)  {rate:9.2f} "
              "Mrays/s")
        print("compare with a recorded one-host run for the efficiency "
              "across hosts")
        torch.distributed.destroy_process_group()
        return 0

    base = None
    for k in sizes(n):
        part = sharding.hybrid_partition(k, 1, devices=devices[:k])
        (_, segments), dt = measure(render_fn(scene, cam, args, part),
                                    devices[:k], args.reps)
        rate = int(segments) / dt / 1e6
        base = rate if base is None else base
        eff = rate / (base * k)
        flag = "" if k == 1 else ("  OK (>=80%)" if eff >= 0.80
                                  else "  BELOW TARGET")
        print(f"devices={k:3d}  {rate:9.2f} Mrays/s  "
              f"efficiency={eff:6.1%}{flag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
