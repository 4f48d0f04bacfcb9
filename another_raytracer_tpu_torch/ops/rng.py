"""Counter-based, stateless RNG (port of ``another_raytracer_tpu.ops.rng``).

Every random draw is a pure function of ``(seed, pixel, sample, bounce, dim)``
via the threefry-2x32 block cipher (Salmon et al., SC'11), so the port draws
the very same sample stream as the JAX package, bit for bit.

torch's CPU ``uint32`` has no add, shift or compare, so the words live in
``int64`` tensors holding values in [0, 2**32) and every operation that can
leave that range is masked with ``& 0xFFFFFFFF``.  Arguments may be Python
ints or int64 tensors (broadcastable).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Rotation constants for threefry2x32 (public algorithm constants).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# Rounds used for rendering draws (13 passes BigCrush, SC'11 Table 2); the
# JAX package, its oracle and the CUDA kernel all read the same value.
ROUNDS = 13


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """threefry-2x32 PRF: returns two uint32 words as int64 values.

    Random123 semantics: key injection after every complete 4-round group
    only (a trailing partial group gets no final injection), rotation
    constants cycling through the 8-entry schedule.  rounds=20 matches the
    Random123 reference vectors.
    """
    ks2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, ks2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for r in range(rounds):
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x0 ^ x1
        if (r + 1) % 4 == 0:
            inject = (r + 1) // 4
            x0 = (x0 + keys[inject % 3]) & MASK32
            x1 = (x1 + keys[(inject + 1) % 3] + inject) & MASK32
    return x0, x1


def _uniform_from_bits(bits):
    """uint32 word -> float32 uniform in [0, 1) from the top 24 bits (exact:
    the shifted value is < 2**24)."""
    return (bits >> 8).to(torch.float32) * (2.0**-24)


def uniform2(seed, pixel, sample, bounce, dim):
    """Two independent uniforms in [0,1) for lanes (dim) and (dim+1).

    Layout: key = (seed, bounce<<8 | dim), counter = (pixel, sample).
    ``dim`` must be even and < 256; ``bounce`` < 2**24.
    """
    k1 = ((bounce << 8) | dim) & MASK32
    b0, b1 = threefry2x32(seed & MASK32, k1, pixel, sample, rounds=ROUNDS)
    return _uniform_from_bits(b0), _uniform_from_bits(b1)


def uniform(seed, pixel, sample, bounce, dim):
    """One uniform in [0,1) for the given lane."""
    u, _ = uniform2(seed, pixel, sample, bounce, dim << 1)
    return u


# --- RNG lane (dim) assignments -------------------------------------------
# Camera draws happen before the bounce loop and use bounce = 0xFF00
# (outside the real bounce range).  Scatter draws use the bounce index.
CAMERA_BOUNCE = 0xFF00
DIM_PIXEL_JITTER = 0  # uses lanes 0,1 (sub-pixel jitter u, v)
DIM_LENS = 2  # lanes 2,3 (defocus disk)
DIM_TIME = 4  # lane 4   (shutter time)
DIM_SCATTER_A = 0  # lanes 0,1 per bounce (direction sampling)
DIM_SCATTER_B = 2  # lanes 2,3 per bounce (radius / reflectance prob)
DIM_MEDIUM = 8  # lanes 8.. per bounce (one per medium; 8 + 2*medium_id)
