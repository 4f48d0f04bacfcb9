"""Port vs JAX: the fused differentiable path on BVH'd sphere scenes — the
record instance of the megakernel's accel mode (K3) and the replay backward
at texture counts above the per-lane-column kernel's 292.

The record rows use the bar of tests/test_torch_diff.py: codes equal on >=
98% of lanes (event and end bit on every row; texture id and checker bit on
live rows), tprev within 1e-5 on the live rows of equal lanes, after the
forward bar of tests/test_mega.py:37-45.

The replay's plain version gets the same numpy residuals and cotangents as
JAX's ``_bwd_large`` (scene 1's T = 485) and must agree to rtol 1e-5 (the
sums run in another order).  Gradients use the bar of
tests/test_mega_diff.py:264-266 (3e-4 of the scale), after a check that the
renders trace the same paths (equal segments, radiance to 1e-5): the port
takes sqrt / sin / cos correctly rounded and XLA does not always, and K3's
hit point differs from the lockstep path's at the ulp level, so a path flips
now and then at an edge (tests/test_torch_diff.py says more).  Against the
JAX kernel, which takes sphere hits as ``o + t d``, the port's megakernel
does too (``megakernel_like_jax``, tests/jax_sphere_record.py); its
fused path and its lockstep path both re-project, and are held to each
other as they are.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.ops.pallas import mega_diff as jmd
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff as tmd
from jax_sphere_record import megakernel_like_jax  # noqa: F401
from jax_sphere_record import megakernel_as_jax
from test_torch_accel import DEPTH, H, W, _both, _forward_bar, _kw, _run_both

torch.set_num_threads(1)


@pytest.fixture
def flags():
    """Set the port's and JAX's FUSED_DIFF inside a test, restored after."""
    saved = tmd.FUSED_DIFF, jmd.FUSED_DIFF

    def set_flags(port=None, ref=None):
        tmd.FUSED_DIFF, jmd.FUSED_DIFF = port, ref
        jrender.clear_trace_caches()

    yield set_flags
    tmd.FUSED_DIFF, jmd.FUSED_DIFF = saved
    jrender.clear_trace_caches()


def test_record_accel_matches_pallas(megakernel_like_jax):
    ref, want, got = _run_both("bvh_sphere_scene",
                               **_kw(spp=2, record_iters=2 * DEPTH))
    _forward_bar(want, got)
    cw, cg = np.asarray(want[2]), got[2].numpy()
    assert cg.shape == (2 * DEPTH, W * H) and got[2].dtype == torch.int32
    ev_end = ((cw & 7) == (cg & 7)).all(axis=0)
    live = ((cw & 3) == 1) | ((cw & 3) == 2)
    equal = ev_end & np.where(live, (cw >> 3) == (cg >> 3), True).all(axis=0)
    assert equal.mean() >= 0.98, equal.mean()
    alive = (cg & 7) != 0
    for tw, tg in zip(want[3], got[3]):
        tw, tg = np.asarray(tw), tg.numpy()
        assert (tg[~alive] == 0).all()
        m = alive & equal[None, :]
        np.testing.assert_allclose(tg[m], tw[m], rtol=0, atol=1e-5)
    # Scatters on many textures, a dielectric's sentinel id, checker cells.
    T = ref.tex_kind.shape[0]
    assert ((cg & 3) == 1).any() and len(np.unique(cg[(cg & 3) == 1] >> 4)) > 8
    assert ((cg >> 4) == T).any() and ((cg & 8) != 0).any()


def test_replay_reference_matches_bwd_large():
    """The plain replay at scene 1's T = 485 against JAX's _bwd_large on the
    same residuals: random codes of every event, end and odd bit and
    texture id (the sentinel included), random throughputs and cotangents."""
    (ref, ref_cam), (port, _) = _both("random_scene")
    T = ref.tex_kind.shape[0]
    assert T == 485 and tmd.replay_instance(T)[0]
    iters, B = 12, 300
    rng = np.random.default_rng(11)
    ev = rng.integers(0, 4, (iters, B))
    codes = (rng.integers(0, T + 1, (iters, B)) * 16 * (ev > 0)
             + 8 * rng.integers(0, 2, (iters, B)) * (ev > 0)
             + 4 * (rng.uniform(size=(iters, B)) < 0.3) + ev).astype(np.int32)
    tprev = rng.uniform(0.0, 1.0, (3, iters, B)).astype(np.float32)
    ghat = rng.uniform(0.2, 1.0, (3, B)).astype(np.float32)

    def decode(row):
        return row & 3, (row & 4) != 0, (row & 8) != 0, row >> 4

    scene_bar = jmd._bwd_large(
        ref, jnp.asarray(codes), tuple(map(jnp.asarray, tprev)),
        tuple(map(jnp.asarray, ghat)), ref.tex_ca, ref.tex_cb, ref.background,
        tuple(ref.background[c] for c in range(3)), True, True, True, decode,
        ref_cam, jnp.zeros(B, jnp.uint32), jnp.zeros(B, jnp.uint32))[0]
    got = tmd.replay_backward(torch.from_numpy(codes),
                              tvec3.V3(*map(torch.from_numpy, tprev)),
                              tvec3.V3(*map(torch.from_numpy, ghat)),
                              port.tex_ca, port.tex_cb, port.background,
                              tmd._flags(port), port.replay_slots())
    for g, key in zip(got, ("tex_ca", "tex_cb", "background")):
        want = np.asarray(getattr(scene_bar, key))
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(), err_msg=key)
        assert np.abs(want).max() > 0


def test_fused_accel_grads_match_jax_and_lockstep(flags):
    """Gradients of sum(w * radiance) in tex_ca, tex_cb and background on the
    70-sphere scene: the port's fused path (K3's record instance and the
    replay, plain versions) against JAX's fused path (interpret), the
    megakernel's re-projection taken out as JAX's kernel has none, and
    against the port's lockstep autograd path, both re-projecting."""
    # Seed 1: the four renders trace the same paths (at 5 of seeds 0-7 an
    # ulp-level difference flips one, module docstring).
    w_, h_, spp, depth, seed = 16, 12, 4, 4, 1
    (ref, ref_cam), (port, cam) = _both("seventy_spheres", w_, h_)
    assert ref.tex_kind.shape[0] > jmd.MAX_TEXTURES
    assert tmd.supports_diff(port, cam, spp, 1, depth)
    assert jmd.supports_diff(ref, ref_cam, spp, 1, depth)
    w = np.random.default_rng(4).uniform(0.2, 1.0, (w_ * h_, 3))
    w = w.astype(np.float32)
    kw = dict(width=w_, height=h_, spp=spp, samples_per_pass=1,
              max_depth=depth, t_min=1e-3)
    keys = ("tex_ca", "tex_cb", "background")

    flags(ref=True)

    def jloss(ca, cb, bg):
        s = ref.replace(tex_ca=ca, tex_cb=cb, background=bg)
        acc, _ = jrender.render_radiance(s, ref_cam, jnp.uint32(seed),
                                         differentiable=True, trainable=keys,
                                         **kw)
        return jnp.sum(jnp.stack([acc.x, acc.y, acc.z], axis=1) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(ref.tex_ca, ref.tex_cb,
                                              ref.background)
    acc_w, seg_w = jrender.render_radiance(ref, ref_cam, jnp.uint32(seed),
                                           differentiable=True,
                                           trainable=keys, **kw)

    def port_grads(fused, like_jax=False):
        flags(port=fused)
        leaves = {k: getattr(port, k).clone().requires_grad_(True)
                  for k in keys}
        with (megakernel_as_jax() if like_jax
              else contextlib.nullcontext()):
            acc, segs = trender.render_radiance(
                port.replace(**leaves), cam, seed, differentiable=True,
                trainable=keys, **kw)
        loss = (torch.stack(tuple(acc), dim=1) * torch.from_numpy(w)).sum()
        return acc, int(segs), torch.autograd.grad(loss, list(leaves.values()))

    acc_u, seg_u, g_u = port_grads(True, like_jax=True)
    acc_f, seg_f, g_f = port_grads(True)
    acc_l, seg_l, g_l = port_grads(False)
    # Same paths first (module docstring).
    assert seg_u == int(seg_w) and seg_f == seg_l
    for acc, acc_want in ((acc_u, jvec3.to_numpy(acc_w)),
                          (acc_f, tvec3.to_numpy(acc_l))):
        np.testing.assert_allclose(tvec3.to_numpy(acc), acc_want, rtol=0,
                                   atol=1e-5)
    for key, gw, gu, gf, gl in zip(keys, want, g_u, g_f, g_l):
        gw = np.asarray(gw)
        for g, g_want in ((gu, gw), (gf, gl.numpy())):
            scale = max(np.abs(g_want).max(), 1e-9)
            np.testing.assert_allclose(g.numpy(), g_want, atol=3e-4 * scale,
                                       rtol=3e-4, err_msg=key)
        assert np.abs(gw).max() > 0, key  # tex_cb: checker odd cells


def test_fused_path_takes_scene1_textures(flags):
    """FUSED_DIFF forced on a BVH'd sphere scene with T = 485 > 292 (the
    per-lane-column replay's limit): the port computes the gradients, and
    they agree with its lockstep path."""
    (_, _), (port, cam) = _both("random_scene", 12, 12)
    kw = dict(width=12, height=12, spp=2, samples_per_pass=1, max_depth=4,
              t_min=1e-3)
    keys = ("tex_ca", "background")
    out = {}
    for fused in (True, False):
        flags(port=fused)
        leaves = {k: getattr(port, k).clone().requires_grad_(True)
                  for k in keys}
        acc, segs = trender.render_radiance(
            port.replace(**leaves), cam, 1, differentiable=True,
            trainable=keys, **kw)
        loss = sum(c.sum() for c in acc)
        out[fused] = (int(segs), torch.autograd.grad(loss, list(leaves.values())))
    assert out[True][0] == out[False][0]
    for gf, gl in zip(out[True][1], out[False][1]):
        scale = float(gl.abs().max())
        assert scale > 0 and torch.isfinite(gf).all()
        torch.testing.assert_close(gf, gl, rtol=3e-4, atol=3e-4 * scale)
