"""threefry-2x32 (Salmon et al., SC'11) with Random123's key schedule, on
int64 tensors that hold uint32 words, and the draw layout of the
configurations' renders: key (seed, bounce << 8 | dim), counter (pixel,
sample), 13 rounds, a uniform from the top 24 bits of a word."""

from __future__ import annotations

MASK = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
ROUNDS = 13

CAMERA_BOUNCE = 0xFF00  # camera draws sit outside the bounce range
DIM_JITTER = 0  # sub-pixel jitter u, v
DIM_LENS = 2  # the lens disk's two uniforms
DIM_TIME = 4  # the shutter time
DIM_SCATTER_A = 0  # per bounce: the direction's two uniforms
DIM_SCATTER_B = 2  # per bounce: the unit-ball radius, the dielectric's coin
DIM_MEDIUM = 8  # per bounce: medium m draws on lane 8 + 2 m


def threefry2x32(k0, k1, x0, x1, rounds: int = ROUNDS):
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for r in range(rounds):
        x0 = (x0 + x1) & MASK
        rot = ROTATIONS[r % 8]
        x1 = ((x1 << rot) & MASK) | (x1 >> (32 - rot))
        x1 = x0 ^ x1
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            x0 = (x0 + ks[j % 3]) & MASK
            x1 = (x1 + ks[(j + 1) % 3] + j) & MASK
    return x0, x1


def uniform2(seed: int, pixel, sample, bounce: int, dim: int, dtype):
    """Two uniforms in [0, 1) for lanes dim, dim + 1 of (pixel, sample)."""
    b0, b1 = threefry2x32(seed & MASK, ((bounce << 8) | dim) & MASK,
                          pixel, sample)
    return ((b0 >> 8).to(dtype) * 2.0 ** -24,
            (b1 >> 8).to(dtype) * 2.0 ** -24)
