"""The draws kernel: ``ops.rng.uniform2`` on CUDA tensors in one launch.

* ``uniform2`` is the wrapper: on CUDA tensors it launches ``art_uniform2``
  of ``csrc/mega_kernel.cu`` (the forward build, which K1's wrapper loads
  too; built at first use, ``_build.py``) or raises.  ``rng.uniform2``
  sends it every call whose tensors are on a CUDA device and runs
  ``rng.uniform2_plain`` on the others.
* ``prepare_launch`` is everything one launch needs.

It replaces no TPU kernel: the JAX package's XLA fuses ``rng.uniform2``'s
int64 ops into one loop fusion, where eager PyTorch, replayed from a CUDA
graph or not, launches them one by one (~120 kernels a call).  The kernel
runs the megakernel's own 13-round threefry-2x32, so its uniforms are
``rng.uniform2_plain``'s bit for bit.  It is bound by bytes: a lane reads
its pixel and sample (and a per-lane bounce) as int64 and writes two
float32.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from another_raytracer_tpu_torch.ops import kernels, rng

# The rounds csrc/mega_kernel.cu is compiled with.
ROUNDS = 13

_fn = None  # the bound C entry, once loaded


def uniform2(seed, pixel, sample, bounce, dim):
    """``rng.uniform2``'s two [B] float32 uniforms from one launch.

    ``pixel`` and ``sample``: contiguous int64 [B] CUDA tensors of uint32
    values on one device; ``bounce``: an int or such a tensor; ``seed``: an
    int or a 0-d int64 tensor on that device, which the launch reads, so a
    CUDA graph's replay draws the seed the tensor holds then.  Raises on
    anything else."""
    run, out = prepare_launch(seed, pixel, sample, bounce, dim)
    if out.shape[1]:
        with torch.cuda.device(out.device):
            err = run()
        if err != 0:
            raise RuntimeError(f"threefry draws launch failed: CUDA error {err}")
        kernels.count("draws")
    return out[0], out[1]


def _lib():
    global _fn
    if _fn is None:
        from another_raytracer_tpu_torch.ops.kernels import _build

        fn = _build.load("mega_kernel").art_uniform2
        P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = [P, U, P, P, P, U, U, I, P, P, P]
        fn.restype = I
        _fn = fn
    return _fn


def _counter(name, t, like=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, not {type(t).__name__}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name} must be int64 (uint32 values), not {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"the draws kernel needs CUDA tensors; {name} is on "
                         f"{t.device}")
    if t.dim() != 1 or (like is not None and t.shape != like.shape):
        raise ValueError(f"{name} must be [B] like pixel, not "
                         f"{list(t.shape)}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, pixel on {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def prepare_launch(seed, pixel, sample, bounce, dim):
    """Everything one launch needs: returns (run, out), ``out`` a [2, B]
    float32 tensor whose rows are the two uniforms.  ``run()`` is the bare
    launch on the current stream and returns the CUDA error code."""
    _counter("pixel", pixel)
    _counter("sample", sample, pixel)
    if isinstance(bounce, torch.Tensor):
        _counter("bounce", bounce, pixel)
        bounce_at, bounce = bounce, 0
    else:
        bounce_at, bounce = None, operator.index(bounce) & rng.MASK32
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.dim() != 0:
            raise TypeError("a tensor seed must be a 0-d int64 tensor")
        if seed.device != pixel.device:
            raise ValueError(f"seed is on {seed.device}, pixel on "
                             f"{pixel.device}")
        seed_at, seed = seed, 0
    else:
        seed_at, seed = None, operator.index(seed) & rng.MASK32
    dim = operator.index(dim)
    if not 0 <= dim < 256:
        raise ValueError(f"dim must be in [0, 256), not {dim}")
    if rng.ROUNDS != ROUNDS:
        raise ValueError(f"the draws kernel runs {ROUNDS} rounds, not "
                         f"rng.ROUNDS = {rng.ROUNDS}")
    n = pixel.shape[0]
    dev = pixel.device
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (None if seed_at is None else seed_at.data_ptr(), seed,
            pixel.data_ptr(), sample.data_ptr(),
            None if bounce_at is None else bounce_at.data_ptr(), bounce, dim,
            n, out.data_ptr(), out.data_ptr() + 4 * n, stream)

    def run(_inputs=(seed_at, pixel, sample, bounce_at, out)):
        # The default keeps the tensors behind ptrs alive.
        return fn(*ptrs)

    return run, out
