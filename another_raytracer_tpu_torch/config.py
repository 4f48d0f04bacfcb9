"""Render configuration (a copy of ``another_raytracer_tpu.config``).

The reference hard-codes its configuration at compile time in
``src/core/tracer_constants.h:6-14`` (720x540, 100 spp, max_depth 50, adaptive
mode selected at src/main.cpp:44) plus one unvalidated CLI arg for the scene
index (src/main.cpp:23-26). Here the whole configuration is a first-class
runtime object consumed by ``render()`` and the CLI.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.Enum):
    """Render execution strategies, mirroring ``engine_mode``
    (reference: src/engine/engine.h:10-16).

    * ``SINGLE``          — one pass over all pixels at full spp.
    * ``PARALLEL_STRIPES``— pixel rows split across devices.
    * ``PARALLEL_IMAGES`` — samples-per-pixel split across devices with a
      final sum-reduction.
    * ``ADAPTIVE``        — hierarchical adaptive subsampling: corner pixels of
      12->6->3 square tiles are path traced and flat tiles are interpolated.

    The parallel modes split over a device partition
    (``parallel/sharding.py``).
    """

    SINGLE = "single"
    PARALLEL_STRIPES = "parallel_stripes"
    PARALLEL_IMAGES = "parallel_images"
    ADAPTIVE = "adaptive"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of a render, promoted from the reference's compile-time
    constants (src/core/tracer_constants.h) to runtime configuration."""

    width: int = 720
    height: int = 540
    samples_per_pixel: int = 100
    max_depth: int = 50
    seed: int = 0
    mode: RenderMode = RenderMode.SINGLE
    # Shadow-acne epsilon: reference uses t_min = 1e-3 (engine.h:455).
    t_min: float = 1e-3
    # Samples traced per ray lane group: the forward megakernel traces
    # width*height*samples_per_pass lanes, each walking its samples with this
    # stride.
    samples_per_pass: int = 1
    # Adaptive mode parameters (reference: engine.h:96-333).
    adaptive_tile: int = 12
    adaptive_threshold: float = 100.0
    adaptive_spass: int | None = None

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
