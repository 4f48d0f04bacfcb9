"""Command-line renderer of the PyTorch / CUDA port.

    python -m another_raytracer_tpu_torch.cli --scene 6 --width 720 \
        --height 540 --spp 100 --max-depth 50 --mode single --device cuda \
        --out output.png

The flags and defaults are the JAX CLI's (``--scene 9 --mode adaptive``)
plus ``--device``.  Every scene renders in every mode: 2 and 6 through the
megakernel's sweep mode, 1 through its accel mode, 3, 4, 5, 7, 8 and 9
through the wavefront with the BVH and Perlin kernels.  Scene 9 renders
``--obj`` or the capsule asset.  The parallel modes split the render over
every visible CUDA device (``--device cuda``) or run on the one device
named.
"""

from __future__ import annotations

import argparse
import sys

import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.utils import imageio, profiling

_PARALLEL = (RenderMode.PARALLEL_STRIPES, RenderMode.PARALLEL_IMAGES)


def main(argv=None):
    p = argparse.ArgumentParser(description="PyTorch/CUDA port of the path "
                                            "tracer")
    p.add_argument("--scene", type=int, default=9,
                   help="scene alias 1..9 (default 9 = mesh, matching "
                        "main.cpp:20)")
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--samples-per-pass", type=int, default=1)
    p.add_argument("--mode", choices=[m.value for m in RenderMode],
                   default=RenderMode.ADAPTIVE.value,
                   help="render mode (default adaptive, matching main.cpp:44; "
                        "it needs 12 | width and height)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="output.png")
    p.add_argument("--scene-seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda: the card, "
                        "and every visible card in the parallel modes; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="mesh scene (9): render this .obj instead of the "
                        "capsule (e.g. the reference's models/cow.obj or "
                        "models/dino.obj; ressources.h.in:7-9)")
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="write a live progress snapshot PNG between passes "
                        "(headless equivalent of the reference's dynamic_gui)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="persist/resume render state (exact resume via "
                        "counter-based RNG; --mode single)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the render")
    p.add_argument("--live", type=int, default=None, metavar="PORT", nargs="?",
                   const=0,
                   help="serve a live progress view over HTTP while rendering "
                        "(0/omitted value = pick a free port; analog of the "
                        "reference's dynamic_gui window, gui.cpp:25-58)")
    p.add_argument("--view", action="store_true",
                   help="after rendering, keep serving the final frame over "
                        "HTTP until ^C (analog of the blocking gui::display, "
                        "gui.cpp:13-23 / main.cpp:55)")
    args = p.parse_args(argv)

    mode = RenderMode(args.mode)
    if mode == RenderMode.ADAPTIVE and (args.width % 12 or args.height % 12):
        p.error("--mode adaptive needs a width and a height divisible by 12 "
                "(the adaptive mode's 12x12 squares)")
    sinks = args.preview or args.checkpoint or args.live is not None
    if args.checkpoint and mode != RenderMode.SINGLE:
        p.error(f"--checkpoint requires --mode single (mode {mode.value} has "
                "no pass-resume stream)")
    if sinks and mode in _PARALLEL:
        p.error(f"--mode {mode.value} renders in one call and cannot stream "
                "progress; use --mode single or adaptive with "
                "--preview/--live")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible (use --device cpu for "
            "the plain PyTorch versions)")

    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_depth=args.max_depth, seed=args.seed,
        samples_per_pass=args.samples_per_pass, mode=mode,
    )
    if args.obj is not None and args.scene == library.SceneAlias.MESH:
        scene, cam_params = library.mesh_scene(
            seed=args.scene_seed, obj_path=args.obj, device=device)
    else:
        scene, cam_params = library.build(args.scene, seed=args.scene_seed,
                                          device=device)
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, device=device,
                                 **cam_params)
    partition = None
    if mode in _PARALLEL:
        from another_raytracer_tpu_torch.parallel import sharding

        # "cuda" alone: every visible card; a named device: that one.
        devices = (None if device.type == "cuda" and device.index is None
                   else [device])
        partition = sharding.default_partition(mode, devices)

    print(f"rendering scene {args.scene} at {cfg.width}x{cfg.height} "
          f"spp={cfg.samples_per_pixel} depth={cfg.max_depth} "
          f"mode={cfg.mode.value} device={device}"
          + (f" partition={partition.shape}" if partition else ""))

    viewer = None
    if args.live is not None or args.view:
        from another_raytracer_tpu_torch.utils.liveview import LiveViewer

        viewer = LiveViewer(port=args.live or 0)
        viewer.start()
        print(f"live view at {viewer.url}")

    def do_render():
        """The mode stays what --mode says: adaptive with a sink streams its
        work frame per level, single with a sink takes the progressive loop
        (which also checkpoints)."""
        if not sinks:
            return render_lib.render(scene, cam, cfg, partition=partition)
        from another_raytracer_tpu_torch.utils import preview as preview_lib

        prev = (preview_lib.ProgressivePreview(
                    args.preview, cfg.width, cfg.height, viewer=viewer)
                if args.preview or args.live is not None else None)
        if mode == RenderMode.SINGLE:
            ckpt = (preview_lib.RenderCheckpoint(args.checkpoint)
                    if args.checkpoint else None)
            return preview_lib.render_progressive(scene, cam, cfg, prev, ckpt)
        return render_lib.render(scene, cam, cfg, progress=prev)

    try:
        with profiling.timed("render", sink=None) as timing:
            if args.profile_dir:
                with profiling.trace(args.profile_dir):
                    img, stats = do_render()  # returns on the host
            else:
                img, stats = do_render()
        # Honest rays/s: traced ray segments including bounces (the wall
        # time includes the kernel build on a first run).
        rays = profiling.RayStats()
        rays.add(stats["segments"], timing.seconds)
        print(f"finished in {rays.seconds*1000:.0f} ms "
              f"({rays.mrays_per_s:.2f} Mrays/s, {rays.segments} segments)")
        imageio.save_png(args.out, img)
        print(f"wrote {args.out}")
        if viewer is not None:
            viewer.update(img, cfg.samples_per_pixel)
            if args.view:
                print(f"serving final frame at {viewer.url} (^C to exit)")
                viewer.serve_forever()
    finally:
        if viewer is not None:
            viewer.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
