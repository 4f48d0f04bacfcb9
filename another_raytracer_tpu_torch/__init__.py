"""another_raytracer_tpu_torch — the PyTorch / CUDA port of another_raytracer_tpu.

The JAX package beside this one is the reference each ported part is held
against.  This package imports ``torch`` and never ``jax``/``flax``.  It keeps
the reference's module names so each counterpart is easy to find:

  * ``config``                — RenderConfig / RenderMode (copied as is);
  * ``models.scene``          — SceneData (a dataclass of tensors) and the
                                numpy SceneBuilder;
  * ``models.library``        — the canonical scenes ported so far;
  * ``ops.rng``               — bit-exact threefry2x32 on int64 tensors;
  * ``ops.vec3`` / ``vecmath`` — column-SoA vectors and samplers;
  * ``ops.camera``            — thin-lens camera and primary rays;
  * ``ops.intersect`` / ``shade`` / ``integrator`` — the lockstep
                                differentiable path (autograd);
  * ``ops.kernels.mega_kernel`` — the megakernel (CUDA): forward (K1) and
                                record (K2) instances, and its plain version;
  * ``ops.kernels.mega_diff`` — the fused differentiable path: K2 + the
                                replay kernel (CUDA) and its plain version;
  * ``ops.render``, ``ops.adaptive`` — the single and adaptive modes;
  * ``parallel.sharding``, ``parallel.multihost`` — the stripes and images
                                modes over a device partition, and across
                                processes (``torch.distributed``);
  * ``grad.diff``             — render_loss, gradients, the adam train step
                                (also over a partition);
  * ``utils``                 — image IO, the native host library (.obj
                                parser, JPEG), preview / checkpoint, the
                                live viewer, profiling;
  * ``cli``, ``bench``        — the command-line renderer and the bench.

Every function that builds tensors takes an explicit ``device``; there is no
global device state.
"""

__version__ = "0.1.0"

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode  # noqa: F401
