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



def _counters(n, seed):
    w = np.random.default_rng(seed).integers(0, 2**32, size=(3, n),
                                             dtype=np.uint64)
    pix, samp, b = (torch.from_numpy(x.astype(np.int64)) for x in w)
    return pix, samp, b & 0xFFFFFF


@pytest.mark.parametrize("bounce_kind", ["int", "tensor"])
@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
def test_uniform2_on_cpu_runs_the_plain_code(bounce_kind, seed_kind):
    """CPU tensors take ``uniform2_plain``: the same bits, and the draws
    kernel's launch count does not move."""
    from another_raytracer_tpu_torch.ops import kernels

    pix, samp, bounces = _counters(3000, 4)
    before = kernels.launch_counts()["draws"]
    for dim in (0, 2, 4, trng.DIM_MEDIUM, trng.DIM_MEDIUM + 2):
        bounce = trng.CAMERA_BOUNCE if bounce_kind == "int" else bounces
        seed = 0xDEADBEEF if seed_kind == "int" else torch.tensor(0xDEADBEEF)
        got = trng.uniform2(seed, pix, samp, bounce, dim)
        want = trng.uniform2_plain(seed, pix, samp, bounce, dim)
        k1 = ((bounce << 8) | dim) & trng.MASK32
        words = trng.threefry2x32(0xDEADBEEF, k1, pix, samp, rounds=13)
        for g, w, x in zip(got, want, words):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert torch.equal(g, w)
            assert torch.equal(g, (x >> 8).to(torch.float32) * 2.0**-24)
    assert kernels.launch_counts()["draws"] == before


@pytest.mark.parametrize("case", ["cpu", "int32", "list"])
def test_draws_kernel_takes_cuda_counters_only(case):
    """The draws kernel's wrapper raises, before it builds anything, on
    counters it does not take (off the card every tensor is one of them)."""
    from another_raytracer_tpu_torch.ops import kernels
    from another_raytracer_tpu_torch.ops.kernels import threefry_kernel

    pix, samp, _ = _counters(16, 5)
    bad = {"cpu": pix, "int32": pix.to(torch.int32), "list": pix.tolist()}[case]
    err = TypeError if case in ("int32", "list") else ValueError
    before = kernels.launch_counts()["draws"]
    with pytest.raises(err):
        threefry_kernel.uniform2(7, bad, samp, 3, 0)
    assert kernels.launch_counts()["draws"] == before


def test_trace_scene_names_the_draws_kernel():
    """``trace_scene`` puts the draws kernel in a category of its own."""
    from another_raytracer_tpu_torch import trace_scene

    event = {"name": "(anonymous namespace)::uniform2_draws_kernel(long "
                     "const*, unsigned int, long const*)", "cat": "kernel"}
    assert trace_scene.category(event) == "draws (threefry uniform2)"
