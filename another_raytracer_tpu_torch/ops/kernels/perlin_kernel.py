"""The Perlin noise kernel K4 (port of
``another_raytracer_tpu.ops.pallas.perlin_kernel``).

* ``perlin_noise`` is the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/perlin_kernel.cu`` (built at first use,
  ``_build.py``) or raises; on CPU tensors it runs the plain version,
  ``ops.shade.perlin_noise``.
* ``perlin_noise_nograd`` is the same value as an autograd Function whose
  backward is zero: the route of differentiable renders whose trainable set
  cannot reach the noise argument (``render.radiance_batch``'s value-only
  rule), where the zero is the true gradient.

The TPU kernel serves one table set (Q == 1); this one takes a table id per
point, so every noise texture of a scene runs it.
"""

from __future__ import annotations

import ctypes

import torch

from another_raytracer_tpu_torch.ops.vec3 import V3

# Table sets that fit in one block's shared memory (6 KB each).
MAX_TABLES = 37


def perlin_noise(scene, perlin_ids, p: V3):
    """[B] Perlin noise of points ``p`` with table set ``perlin_ids`` ([B]
    int, clamped to the scene's tables), the value of
    ``ops.shade.perlin_noise``.  CUDA tensors launch the kernel; CPU tensors
    run the plain version; any other device raises."""
    dev = p.x.device
    if dev.type == "cpu":
        from another_raytracer_tpu_torch.ops import shade

        return shade.perlin_noise(scene, perlin_ids, p)
    if dev.type != "cuda":
        raise ValueError(f"no Perlin kernel for device {dev}")
    run, out = prepare_launch(scene, perlin_ids, p)
    with torch.cuda.device(dev):
        err = run()
    if err != 0:
        raise RuntimeError(f"perlin_kernel launch failed: CUDA error {err}")
    if p.x.shape[0]:
        perlin_noise.launches += 1
    return out


# Launches of the CUDA kernel, incremented once per launch and nowhere else.
perlin_noise.launches = 0


class _NoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scene, perlin_ids, px, py, pz):
        return perlin_noise(scene, perlin_ids, V3(px, py, pz))

    @staticmethod
    def backward(ctx, grad):
        z = torch.zeros_like(grad)
        return None, None, z, z, z


def perlin_noise_nograd(scene, perlin_ids, p: V3):
    """``perlin_noise`` with a zero gradient with respect to ``p`` (the
    JAX ``perlin_noise_tpu_nograd``): exact where ``p`` has no trainable
    dependence, which the caller guarantees."""
    return _NoGrad.apply(scene, perlin_ids, p.x, p.y, p.z)


def _lib():
    from another_raytracer_tpu_torch.ops.kernels import _build

    lib = _build.load("perlin_kernel")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.art_perlin_noise.argtypes = [P, P, P, P, P, P, I, I, P, P]
    lib.art_perlin_noise.restype = I
    return lib


def prepare_launch(scene, perlin_ids, p: V3):
    """Everything one CUDA launch needs: returns (run, out).  ``run()`` is
    the bare launch and returns the CUDA error code."""
    dev = p.x.device
    n = p.x.shape[0]
    q = scene.per_perm.shape[0]
    if q > MAX_TABLES:
        raise ValueError(f"{q} Perlin table sets do not fit in shared memory "
                         f"(at most {MAX_TABLES})")
    if scene.per_perm.device != dev:
        raise ValueError(f"scene is on {scene.per_perm.device}, points on {dev}")
    comps = [c.detach().to(torch.float32).contiguous() for c in p]
    if any(c.shape != (n,) for c in comps):
        raise ValueError("p must be a V3 of [B] tensors")
    pid = torch.as_tensor(perlin_ids, device=dev)
    pid = pid.expand(n) if pid.dim() == 0 else pid
    if pid.shape != (n,):
        raise ValueError(f"perlin_ids must be a scalar or [{n}]")
    pid = pid.to(torch.int32).contiguous()
    perm = scene.per_perm.to(torch.int32).contiguous()
    ran = scene.per_ranvec.detach().to(torch.float32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*comps, pid, perm, ran, q, n, out)
    ptrs = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a
                 for a in args) + (stream,)

    def run(_inputs=args):  # the default keeps the tensors behind ptrs alive
        return lib.art_perlin_noise(*ptrs)

    return run, out
