"""Command-line renderer of the PyTorch / CUDA port.

    python -m another_raytracer_tpu_torch.cli --scene 6 --width 720 \
        --height 540 --spp 100 --max-depth 50 --mode single --device cuda \
        --out output.png

The flags and defaults are the JAX CLI's (``--scene 9 --mode adaptive``)
plus ``--device``.  Every scene renders in modes ``single`` and
``adaptive``: 2 and 6 through the megakernel's sweep mode, 1 through its
accel mode, 3, 4, 5, 7, 8 and 9 through the wavefront with the BVH and
Perlin kernels.  Scene 9 renders ``--obj`` or the capsule asset.  The flags
named in ``_UNPORTED_FLAGS`` and the parallel modes (ROADMAP M18) fail.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera as camera_lib
from another_raytracer_tpu_torch.ops import render as render_lib
from another_raytracer_tpu_torch.utils import imageio

# Flags accepted for parity with the JAX CLI but not ported yet.
_UNPORTED_FLAGS = {
    "preview": "ROADMAP M20 (progress preview)",
    "checkpoint": "ROADMAP M20 (checkpoint / resume)",
    "profile_dir": "ROADMAP M20 (profiling)",
    "live": "ROADMAP M20 (live view)",
    "view": "ROADMAP M20 (live view)",
}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA port of the path tracer.  The parallel "
                    "modes and --preview, --checkpoint, --profile-dir, "
                    "--live, --view fail until ported (ROADMAP.md).")
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
                        "it needs 12 | width and height; 'parallel_stripes' "
                        "and 'parallel_images' are not ported yet)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="output.png")
    p.add_argument("--scene-seed", type=int, default=1234)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; 'cpu' runs "
                        "the kernels' plain PyTorch versions)")
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="mesh scene (9): render this .obj instead of the "
                        "capsule (e.g. the reference's models/cow.obj or "
                        "models/dino.obj; ressources.h.in:7-9)")
    p.add_argument("--preview", default=None, metavar="PNG",
                   help="live progress snapshot PNG (not ported yet)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="persist/resume render state (not ported yet)")
    p.add_argument("--profile-dir", default=None,
                   help="profiler trace of the render (not ported yet)")
    p.add_argument("--live", type=int, default=None, metavar="PORT", nargs="?",
                   const=0, help="live HTTP progress view (not ported yet)")
    p.add_argument("--view", action="store_true",
                   help="serve the final frame over HTTP (not ported yet)")
    args = p.parse_args(argv)

    for flag, item in _UNPORTED_FLAGS.items():
        value = getattr(args, flag)
        if value is not None and value is not False:  # --live gives 0
            p.error(f"--{flag.replace('_', '-')} is not ported yet ({item})")
    mode = RenderMode(args.mode)
    if mode in (RenderMode.PARALLEL_STRIPES, RenderMode.PARALLEL_IMAGES):
        p.error(f"--mode {mode.value} is not ported yet (ROADMAP M18); use "
                "--mode single or adaptive")
    if mode == RenderMode.ADAPTIVE and (args.width % 12 or args.height % 12):
        p.error("--mode adaptive needs a width and a height divisible by 12 "
                "(the adaptive mode's 12x12 squares)")
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
    try:
        if args.obj is not None and args.scene == library.SceneAlias.MESH:
            scene, cam_params = library.mesh_scene(
                seed=args.scene_seed, obj_path=args.obj, device=device)
        else:
            scene, cam_params = library.build(args.scene, seed=args.scene_seed,
                                              device=device)
    except NotImplementedError as e:
        p.error(str(e))
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, device=device,
                                 **cam_params)

    print(f"rendering scene {args.scene} at {cfg.width}x{cfg.height} "
          f"spp={cfg.samples_per_pixel} depth={cfg.max_depth} "
          f"mode={cfg.mode.value} device={device}")
    t0 = time.perf_counter()
    img, stats = render_lib.render(scene, cam, cfg)  # returns on the host
    elapsed = time.perf_counter() - t0
    segments = stats["segments"]
    # Honest rays/s: traced ray segments including bounces (the wall time
    # includes the kernel build on a first run).
    print(f"finished in {elapsed*1000:.0f} ms "
          f"({segments/elapsed/1e6:.2f} Mrays/s, {segments} segments)")
    imageio.save_png(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
