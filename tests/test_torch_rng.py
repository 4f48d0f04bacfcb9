"""Port vs JAX: the counter-based threefry RNG must agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.ops import rng as jrng
from another_raytracer_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=(4, n),
                                                dtype=np.uint64)


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_matches_reference(rounds):
    w = _words(4096, rounds)
    want = jrng.threefry2x32(*(jnp.asarray(x.astype(np.uint32)) for x in w),
                             rounds=rounds)
    got = trng.threefry2x32(*(torch.from_numpy(x.astype(np.int64)) for x in w),
                            rounds=rounds)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_threefry_random123_vectors():
    # Random123 reference vectors for threefry2x32, 20 rounds
    # (tests/test_rng.py:13-29).
    for key_ctr, want in [
        ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
        ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
        ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
         (0xC4923A9C, 0x483DF7A0)),
    ]:
        x0, x1 = trng.threefry2x32(*(torch.tensor([v]) for v in key_ctr),
                                   rounds=20)
        assert (int(x0), int(x1)) == want


def test_uniform2_matches_reference():
    px = np.arange(2000, dtype=np.uint32) * 977
    samp = (px * 7 + 3).astype(np.uint32)
    bounces = np.random.default_rng(1).integers(0, 50, 2000).astype(np.uint32)
    cases = [(7, 0, 0), (3, 2, 2), (0xDEADBEEF, trng.CAMERA_BOUNCE, 4),
             (11, bounces, 0)]
    for seed, bounce, dim in cases:
        jb = jnp.asarray(bounce, jnp.uint32)
        tb = torch.from_numpy(np.asarray(bounce, np.int64))
        want = jrng.uniform2(seed, jnp.asarray(px), jnp.asarray(samp), jb, dim)
        got = trng.uniform2(seed, torch.from_numpy(px.astype(np.int64)),
                            torch.from_numpy(samp.astype(np.int64)), tb, dim)
        for a, b in zip(want, got):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    u = trng.uniform(5, torch.arange(64), torch.zeros(64, dtype=torch.int64), 1, 1)
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform(5, jnp.arange(64, dtype=jnp.uint32),
                                jnp.zeros(64, jnp.uint32), 1, 1)), u.numpy())

