"""Port vs JAX: the stripes and images modes over a device partition
(``parallel/sharding.py``), the adaptive mode's batches over a partition,
and the sharded training step.

The port's partitions run over ``[cpu] * n`` (a repeated device, one copy
of the scene); JAX's over conftest's 8 virtual CPU devices.  Bars: stripes
bit-equal to the port's single render; images to rtol 1e-5 (the shards'
float32 partial sums are added in another order); segments equal.  Against
JAX, the bar of tests/test_mega.py:37-45 (<= 2% of values off by > 2e-2,
median difference < 1e-5, segments within max(4, 1%)), as in
tests/test_torch_render.py.  Gradients: 2e-4 of each leaf's scale, as in
tests/test_torch_diff.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.parallel import sharding as jsharding
from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.ops import adaptive as tadaptive
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff as tmd
from another_raytracer_tpu_torch.parallel import sharding

torch.set_num_threads(1)

W, H, SPP, DEPTH = 48, 24, 4, 4  # tests/test_sharding.py
KW = dict(width=W, height=H, spp=SPP, samples_per_pass=2, max_depth=DEPTH,
          t_min=1e-3)
GRIDS = [(8, 1), (1, 4), (4, 2), (2, 2), (1, 8)]


def cpus(n_tile, n_spp):
    return sharding.hybrid_partition(n_tile, n_spp,
                                     devices=["cpu"] * (n_tile * n_spp))


@pytest.fixture(scope="module")
def cornell():
    scene, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    ref, segs = trender.render_radiance(scene, cam, 1, **KW)
    return scene, cam, params, tvec3.to_numpy(ref), int(segs)


def against_jax(got, got_segs, want, want_segs):
    assert abs(got_segs - want_segs) <= max(4, 0.01 * want_segs)
    d = np.abs(got - want)
    assert (d > 2e-2).mean() <= 0.02
    assert np.median(d) < 1e-5


@pytest.mark.parametrize("n_tile,n_spp", GRIDS)
def test_sharded_matches_single(cornell, n_tile, n_spp):
    scene, cam, params, ref, ref_segs = cornell
    part = cpus(n_tile, n_spp)
    assert part.shape == {"tile": n_tile, "spp": n_spp}
    acc, segs = sharding.render_radiance_sharded(scene, cam, 1,
                                                 partition=part, **KW)
    got = tvec3.to_numpy(acc)
    assert int(segs) == ref_segs
    if n_spp == 1:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if n_tile * n_spp > 4:
        return  # JAX compiles each grid anew; the four small ones suffice
    jscene, _ = jlib.cornell_box()
    jcamera = jcam.make_camera(aspect_ratio=W / H, **params)
    want, want_segs = jsharding.render_radiance_sharded(
        jscene, jcamera, jnp.uint32(1),
        mesh=jsharding.hybrid_mesh(n_tile, n_spp), **KW)
    against_jax(got, int(segs), jvec3.to_numpy(want), int(want_segs))


def test_empty_sample_shards_trace_nothing(cornell):
    """spp 4 over 8 sample shards: shards 4-7 start past the cap, so every
    lane is born dead; their sums are zero."""
    scene, cam, _, _, _ = cornell
    pix = torch.arange(W * H)
    for k in range(4, 8):
        acc, segs = trender.radiance_batch(
            scene, cam, pix, 1, width=W, height=H, sample_start=k,
            n_samples=1, spp_cap=SPP, samples_per_pass=2, max_depth=DEPTH,
            t_min=1e-3)
        assert int(segs) == 0
        assert all(bool((c == 0).all()) for c in acc)


def test_ragged_pixels_trace_unpadded():
    """36x18 = 648 pixels over 5 stripes: the port traces the short last
    stripe as it is and counts single mode's segments; JAX pads by
    repeating the first pixels, traces them again and counts more."""
    w, h = 36, 18
    kw = dict(KW, width=w, height=h)
    scene, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=w / h, device="cpu", **params)
    ref, ref_segs = trender.render_radiance(scene, cam, 1, **kw)
    acc, segs = sharding.render_radiance_sharded(scene, cam, 1,
                                                 partition=cpus(5, 1), **kw)
    np.testing.assert_array_equal(tvec3.to_numpy(acc), tvec3.to_numpy(ref))
    assert int(segs) == int(ref_segs)
    jscene, _ = jlib.cornell_box()
    jcamera = jcam.make_camera(aspect_ratio=w / h, **params)
    want, want_segs = jsharding.render_radiance_sharded(
        jscene, jcamera, jnp.uint32(1), mesh=jsharding.hybrid_mesh(5, 1), **kw)
    assert (w * h) % 5 and int(want_segs) > int(ref_segs)
    want1, want1_segs = jrender.render_radiance(jscene, jcamera,
                                                jnp.uint32(1), **kw)
    assert int(want_segs) > int(want1_segs)
    against_jax(tvec3.to_numpy(acc), int(segs), jvec3.to_numpy(want1),
                int(want1_segs))


@pytest.mark.parametrize("mode", [RenderMode.PARALLEL_STRIPES,
                                  RenderMode.PARALLEL_IMAGES])
def test_parallel_modes_through_render(cornell, mode):
    scene, cam, _, ref, ref_segs = cornell
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                       max_depth=DEPTH, seed=1, samples_per_pass=2, mode=mode)
    single, _ = trender.render(scene, cam, cfg.replace(mode=RenderMode.SINGLE))
    part = sharding.default_partition(mode, devices=["cpu"] * 4)
    assert part.shape == ({"tile": 1, "spp": 4}
                          if mode == RenderMode.PARALLEL_IMAGES
                          else {"tile": 4, "spp": 1})
    img, stats = trender.render(scene, cam, cfg, partition=part)
    assert stats == {"segments": ref_segs, "partition": part.shape}
    if mode == RenderMode.PARALLEL_STRIPES:
        np.testing.assert_array_equal(img, single)
    else:  # uint8 quantisation can flip on exact ties
        assert (img != single).mean() < 0.001
    with pytest.raises(ValueError, match="cannot stream progress"):
        trender.render(scene, cam, cfg, progress=object(), partition=part)


@pytest.mark.parametrize("n_tile,n_spp", [(4, 1), (4, 2)])
def test_adaptive_over_a_partition(n_tile, n_spp):
    """The adaptive mode's level batches over a partition give the image of
    the one-device adaptive render (tests/test_adaptive.py:77-100)."""
    scene, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=2.0, device="cpu", **params)
    cfg = RenderConfig(width=48, height=24, samples_per_pixel=SPP,
                       max_depth=DEPTH, seed=3, mode=RenderMode.ADAPTIVE)
    one, st1 = tadaptive.render_adaptive(scene, cam, cfg)
    img, st = trender.render(scene, cam, cfg, partition=cpus(n_tile, n_spp))
    np.testing.assert_array_equal(img, one)
    assert st["traced_pixels"] == st1["traced_pixels"]
    assert st["segments"] == st1["segments"]
    assert st["batches"] == st1["batches"] > 0
    assert st["partition"] == {"tile": n_tile, "spp": n_spp}
    assert st1["partition"] is None
    with pytest.raises(TypeError):
        tadaptive.render_adaptive(scene, cam, cfg, partition=object())


@pytest.mark.parametrize("n_tile,n_spp,fused_calls",
                         [(4, 1, 4), (1, 2, 0), (5, 1, 5), (7, 1, 7),
                          (25, 1, 24)])
def test_sharded_train_step_matches_jax(monkeypatch, n_tile, n_spp,
                                        fused_calls):
    """The sharded step (``dryrun_multichip``'s): a tile partition takes the
    fused path per shard (K2 + the replay's plain versions here), an spp
    split the lockstep path; loss and gradients against JAX's unsharded
    ``render_value_and_grad`` (its lockstep path on the CPU).  192 pixels
    over 5 tiles leave a short last chunk (36 of 39), over 7 one of 24 of
    28, over 25 an empty one (24 chunks of 8): one fused call per non-empty
    shard, no pad lanes."""
    w, h, spp, depth = 16, 12, 4, 4  # tests/test_torch_diff.py's cornell
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=1, max_depth=depth,
              t_min=1e-3)
    target = np.random.default_rng(0).uniform(0.0, 0.5, (w * h, 3))
    target = target.astype(np.float32)
    jscene, params = jlib.cornell_box()
    jcamera = jcam.make_camera(aspect_ratio=w / h, **params)
    jparams, _ = jdiff.split_params(jscene)
    loss_w, grads_w = jdiff.render_value_and_grad(
        jparams, jscene, jcamera, jnp.asarray(target), jnp.uint32(0), **kw)

    scene, _ = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=w / h, device="cpu", **params)
    calls = []
    real = tmd.radiance_fused
    monkeypatch.setattr(tmd, "radiance_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tparams, _ = diff.split_params(scene)
    part = cpus(n_tile, n_spp)
    loss, grads = diff.render_value_and_grad(
        tparams, scene, cam, torch.from_numpy(target), 0, partition=part, **kw)
    assert len(calls) == fused_calls
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    for k in grads_w:
        want, got = np.asarray(grads_w[k]), grads[k].numpy()
        scale = max(np.abs(want).max(), 1e-9)
        np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=2e-4,
                                   err_msg=k)
    # One adam step over the partition leaves the parameters finite and
    # moved.
    state, step = diff.make_train_step(scene, cam, torch.from_numpy(target),
                                       partition=part, **kw)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss1 = step(state, 0)
    np.testing.assert_allclose(float(loss1), float(loss_w), rtol=1e-5)
    assert all(bool(torch.isfinite(v).all()) for v in state.params.values())
    assert not torch.equal(state.params["tex_ca"], before["tex_ca"])


def test_ragged_differentiable_render_matches_jax():
    """``render_radiance_sharded(differentiable=True)`` over 5 tiles of 192
    pixels (a short last chunk, on the fused path) against JAX's over
    ``hybrid_mesh(5, 1)``: the per-channel sums, and the gradient of their
    total in ``tex_ca``."""
    w, h, spp, depth = 16, 12, 4, 4
    kw = dict(width=w, height=h, spp=spp, samples_per_pass=1, max_depth=depth,
              t_min=1e-3)
    jscene, params = jlib.cornell_box()
    jcamera = jcam.make_camera(aspect_ratio=w / h, **params)
    mesh = jsharding.hybrid_mesh(5, 1)

    def jtotal(tex_ca):
        acc, _ = jsharding.render_radiance_sharded(
            jscene.replace(tex_ca=tex_ca), jcamera, jnp.uint32(0), mesh=mesh,
            differentiable=True, **kw)
        sums = jnp.stack([acc.x.sum(), acc.y.sum(), acc.z.sum()])
        return sums.sum(), sums

    import jax

    (_, want_sums), want_g = jax.value_and_grad(jtotal, has_aux=True)(
        jscene.tex_ca)

    scene, _ = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=w / h, device="cpu", **params)
    tex_ca = scene.tex_ca.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        acc, _ = sharding.render_radiance_sharded(
            scene.replace(tex_ca=tex_ca), cam, 0, partition=cpus(5, 1),
            differentiable=True, trainable=diff.DEFAULT_TRAINABLE, **kw)
        sums = torch.stack([c.sum() for c in acc])
        (g,) = torch.autograd.grad(sums.sum(), [tex_ca])
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(want_sums),
                               rtol=1e-5)
    want_g = np.asarray(want_g)
    scale = max(np.abs(want_g).max(), 1e-9)
    np.testing.assert_allclose(g.numpy(), want_g, atol=2e-4 * scale,
                               rtol=2e-4)


def test_partition_shapes():
    part = sharding.hybrid_partition(devices=["cpu"] * 3)
    assert part.shape == {"tile": 3, "spp": 1}
    assert sharding.hybrid_partition(n_spp=2, devices=["cpu"] * 4).shape == \
        {"tile": 2, "spp": 2}
    with pytest.raises(ValueError):
        sharding.hybrid_partition(4, 2, devices=["cpu"] * 4)
    assert [sharding.stripe(10, k, 4) for k in range(4)] == \
        [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert sharding.stripe(2, 3, 4) == (2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.hybrid_partition()
