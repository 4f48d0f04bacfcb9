"""Progressive render preview and checkpointing (port of
``another_raytracer_tpu.utils.preview``).

The reference shows live progress in an X11 window (``dynamic_gui``,
gui.cpp:25-58) and persists nothing.  Here both are host-side callbacks
around the sample loop:

  * ``ProgressivePreview`` turns the linear accumulator into a frame
    between passes and writes it as a PNG every ``interval`` updates and/or
    pushes it to a live viewer (``utils/liveview.py``);
  * ``RenderCheckpoint`` persists the accumulator, the samples done and the
    seed to an ``.npz`` (the JAX package's keys) after each chunk, so an
    interrupted render resumes exactly: the RNG keys on absolute (pixel,
    sample) ids, so the remaining samples are those of an uninterrupted
    run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import color as color_lib


def _to_uint8(radiance_sum, samples) -> np.ndarray:
    """Linear float64 sums [N, 3] -> uint8 [N, 3], in float32 as the JAX
    package converts them."""
    r = torch.from_numpy(np.asarray(radiance_sum, np.float32))
    return color_lib.to_uint8(r, samples).numpy()


@dataclasses.dataclass
class ProgressivePreview:
    """Between-pass progress sink: PNG snapshots to ``path`` and/or a live
    HTTP viewer — together the headless analog of the reference's
    dynamic_gui window (gui.cpp:25-58)."""

    path: Optional[str]
    width: int
    height: int
    interval: int = 1  # write the PNG every N updates
    viewer: object = None  # optional LiveViewer; pushed every update
    _count: int = 0

    def update(self, radiance_sum: np.ndarray, samples_done: int) -> None:
        """Push a linear radiance accumulator [H*W, 3] (gamma applied
        here)."""
        self._count += 1
        write_file = self.path is not None and self._count % self.interval == 0
        if not write_file and self.viewer is None:
            return
        img = _to_uint8(radiance_sum, max(samples_done, 1))
        self._emit(img.reshape(self.height, self.width, 3), samples_done,
                   write_file)

    def update_image(self, img_uint8: np.ndarray, progress: int) -> None:
        """Push an already tonemapped frame (the adaptive mode's work frame
        per level, the reference's per-square ``dgui.show``,
        engine.h:307)."""
        self._count += 1
        write_file = self.path is not None and self._count % self.interval == 0
        self._emit(np.asarray(img_uint8, np.uint8), progress, write_file)

    def _emit(self, img: np.ndarray, progress: int, write_file: bool) -> None:
        if self.viewer is not None:
            self.viewer.update(img, progress)
        if write_file:
            from another_raytracer_tpu_torch.utils import imageio

            imageio.save_png(self.path, img)


def _hash_tensor(h, t) -> None:
    a = t.detach().cpu().numpy()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(np.ascontiguousarray(a).tobytes())


def render_fingerprint(scene, cam, config) -> str:
    """Digest of a render stream: the scene's tensors and static fields,
    the camera, and every config knob that changes sample values.  Two
    renders share partial accumulators iff their fingerprints match.

    Everything is brought to the host first, so the digest does not depend
    on the device; only the dataclass fields enter it, not the kernel
    tables a render packs at first use.  ``samples_per_pixel`` is not part
    of it: extending a finished render to a higher spp cap resumes the same
    stream."""
    h = hashlib.sha1()
    for name, t in sorted(scene.tensors().items()):
        h.update(name.encode())
        _hash_tensor(h, t)
    h.update(repr([(f, getattr(scene, f))
                   for f in scene_lib.STATIC_FIELDS]).encode())
    for f in dataclasses.fields(cam):
        value = getattr(cam, f.name)
        h.update(f.name.encode())
        if isinstance(value, torch.Tensor):
            _hash_tensor(h, value)
        else:
            h.update(repr(value).encode())
    h.update(repr((config.width, config.height, config.samples_per_pass,
                   config.max_depth, config.seed, config.t_min)).encode())
    return h.hexdigest()


@dataclasses.dataclass
class RenderCheckpoint:
    path: str

    def save(self, radiance_sum: np.ndarray, samples_done: int, seed: int,
             width: int, height: int, fingerprint: str = "") -> None:
        tmp = Path(str(self.path) + ".tmp")
        np.savez(tmp, radiance=radiance_sum, samples_done=samples_done,
                 seed=seed, width=width, height=height,
                 fingerprint=np.str_(fingerprint))
        # np.savez appends .npz to the name it opens; the rename is atomic.
        Path(str(tmp) + ".npz").replace(self.path)

    def load(self, fingerprint: str = None) -> Optional[dict]:
        """The checkpoint's arrays, or None when there is none or when
        ``fingerprint`` is given and differs from the stamped one (with a
        RuntimeWarning): samples of another stream must not be mixed in."""
        p = Path(self.path)
        if not p.exists():
            return None
        with np.load(p) as z:
            state = {k: z[k] for k in z.files}
        if fingerprint is not None and str(state.get("fingerprint", "")) \
                != fingerprint:
            warnings.warn(
                f"checkpoint {self.path} was produced by a different render "
                "(scene/camera/config fingerprint mismatch); ignoring it and "
                "starting fresh", RuntimeWarning, stacklevel=2)
            return None
        return state


def render_progressive(scene, cam, config,
                       preview: ProgressivePreview = None,
                       checkpoint: RenderCheckpoint = None):
    """Single-mode progressive render with preview and checkpoint / resume.

    A host loop over chunks of ``samples_per_pass`` samples, each one
    ``render.radiance_batch`` call on the scene's device, summed into a
    float64 accumulator on the host; the preview and the checkpoint are fed
    between chunks.  Returns (uint8 image [H, W, 3], stats)."""
    from another_raytracer_tpu_torch.ops import render as render_lib

    W, H, spp = config.width, config.height, config.samples_per_pixel
    spass = min(config.samples_per_pass, spp)
    pixel_ids = torch.arange(W * H, dtype=torch.int64, device=scene.device)

    start_chunk = 0
    acc = np.zeros((W * H, 3), np.float64)
    fp = render_fingerprint(scene, cam, config) if checkpoint is not None else ""
    if checkpoint is not None:
        state = checkpoint.load(fingerprint=fp)
        if state is not None and int(state["width"]) == W \
                and int(state["height"]) == H:
            acc = state["radiance"].astype(np.float64)
            start_chunk = int(state["samples_done"]) // spass

    segments = 0
    n_chunks = -(-spp // spass)
    for chunk in range(start_chunk, n_chunks):
        r, segs = render_lib.radiance_batch(
            scene, cam, pixel_ids, config.seed, width=W, height=H,
            sample_start=chunk * spass, n_samples=spass, spp_cap=spp,
            samples_per_pass=spass, max_depth=config.max_depth,
            t_min=config.t_min)
        acc += torch.stack(tuple(r), dim=1).cpu().numpy()
        segments += int(segs)
        done = min((chunk + 1) * spass, spp)
        # Console progress (the reference's "\r...%" lines, engine.h:80,320).
        print(f"\rprogress: {done * 100 // spp}% ({done}/{spp} spp)",
              end="" if done < spp else "\n", file=sys.stderr, flush=True)
        if preview is not None:
            preview.update(acc, done)
        if checkpoint is not None:
            checkpoint.save(acc, done, config.seed, W, H, fingerprint=fp)

    img = _to_uint8(acc, spp).reshape(H, W, 3)
    return img, {"segments": segments, "resumed_at_chunk": start_chunk}
