"""another_raytracer_tpu_torch — the PyTorch / CUDA port of another_raytracer_tpu.

The JAX package beside this one is the reference each ported part is held
against.  This package imports ``torch`` and never ``jax``/``flax``.  It keeps
the reference's module names so each counterpart is easy to find:

  * ``config``                — RenderConfig / RenderMode (copied as is);
  * ``models.scene``          — SceneData (a dataclass of tensors) and the
                                numpy SceneBuilder;
  * ``models.library``        — the canonical scenes ported so far;
  * ``ops.rng``               — bit-exact threefry2x32 on int64 tensors;
  * ``ops.camera``            — thin-lens camera and primary rays;
  * ``ops.kernels.mega_kernel`` — the forward megakernel (CUDA) and its plain
                                PyTorch version;
  * ``ops.render``            — single-mode render driver;
  * ``cli``                   — the command-line renderer.

Every function that builds tensors takes an explicit ``device``; there is no
global device state.
"""

__version__ = "0.1.0"

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode  # noqa: F401
