"""Port vs JAX: the training path — the record-mode megakernel (K2), the
replay backward, ``render_loss`` and its gradients, the fused-path gate and
the adam train step.

K2's plain version is held against the Pallas kernel in interpret mode with
the forward bar of tests/test_mega.py:37-45 plus the residual rows: codes
equal on >= 98% of lanes (event and end bit on every row; texture id and
checker bit where the event is a scatter or a light hit — on idle rows the
JAX kernel may carry a stale checker bit and writes the stale throughput,
which the replay ignores) and tprev within 1e-5 on the live rows of equal
lanes.  The replay's plain version gets the same numpy residuals and
cotangents as JAX's ``_traced_bwd`` and must agree to rtol 1e-5 (the sums
run in another order).

Gradients of ``render_loss`` use the bar of tests/test_mega_diff.py:123-128
(2e-4 on the Cornell box, 3e-4 on the metal / dielectric and checker
scenes).  That bar needs both packages to trace the same paths: XLA's
sin/cos (glibc's sinf/cosf) are an ulp from the correctly rounded values the
port computes on ~1.2% of inputs, which now and then flips a path at an
edge, and one flipped miss or light event moves a gradient by ~1e-3 of its
scale at these sizes.  Each such test therefore first checks that the two
renders agree lane for lane (equal segment counts, per-pixel radiance to
1e-5), at seeds where they do, and then holds the gradients to the bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from another_raytracer_tpu.grad import diff as jdiff
from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import render as jrender
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.ops.pallas import mega_diff as jmd
from another_raytracer_tpu.ops.pallas import mega_kernel as jmk
from another_raytracer_tpu_torch import bench
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff as tmd
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk

torch.set_num_threads(1)

W, H, SPP, DEPTH = 16, 12, 4, 4


def _metal_scene():
    # tests/test_mega_diff.py:159-168: lambertian, dielectric, metal.
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=2)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.8, 0.8, 0.0)))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.sphere((1, 0, -1), 0.5, b.metal(color=(0.8, 0.6, 0.2), fuzz=0.4))
    return b.build(), dict(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90)


def _mixed_scene():
    # Lens + motion + metal + dielectric + checker (tests/test_mega.py:53-66).
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    return b.build(), dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1),
                           vfov=60.0, aperture=0.1, focus_dist=2.5, time0=0.0,
                           time1=1.0)


def _many_textures_scene():
    # 21 solid textures (> MAX_TEXTURES = 16: JAX's gather/scatter replay).
    rng = np.random.default_rng(9)
    b = JBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -1000, 0), 1000, b.lambertian(color=(0.5, 0.5, 0.5)))
    for _ in range(20):
        c = (rng.uniform(-3, 3), rng.uniform(0.2, 0.5), rng.uniform(-3, 1))
        b.sphere(c, 0.3, b.lambertian(color=tuple(rng.uniform(0.1, 0.9, 3))))
    return b.build(), dict(lookfrom=(6, 2, 3), lookat=(0, 0.3, -1), vfov=30.0)


SCENES = {
    "cornell": jlib.cornell_box,
    "metal_dielectric": _metal_scene,
    "checker": jlib.two_spheres,
    "mixed": _mixed_scene,
    "many_textures": _many_textures_scene,
}


def _both(name, width=W, height=H):
    """(JAX scene, JAX camera), (port scene, port camera)."""
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=width / height, **params)
    return ((ref, ref_cam), (tscene.scene_from_reference(ref),
                             tcam.camera_from_reference(ref_cam)))


def _record_kw(spp=SPP, depth=DEPTH):
    return dict(width=W, height=H, sample_stride=1, sample_end=spp,
                spp_cap=spp, max_depth=depth, t_min=1e-3,
                record_iters=spp * depth)


def _port_record(name, seed=3):
    _, (port, cam) = _both(name)
    return port, tmk.trace_regenerative_mega(
        port, cam, torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64),
        seed, **_record_kw())


@pytest.fixture
def fused_flag():
    """Set the port's and JAX's FUSED_DIFF inside a test, restored after."""
    saved = tmd.FUSED_DIFF, jmd.FUSED_DIFF

    def set_flag(port, ref=None):
        tmd.FUSED_DIFF, jmd.FUSED_DIFF = port, ref
        jrender.clear_trace_caches()

    yield set_flag
    tmd.FUSED_DIFF, jmd.FUSED_DIFF = saved
    jrender.clear_trace_caches()


# --------------------------------------------------------------------------
# K2: record mode, plain version vs the Pallas kernel (interpret)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "mixed"])
def test_record_mode_matches_pallas(name):
    (ref, ref_cam), (port, cam) = _both(name)
    kw = _record_kw()
    want = jmk.trace_regenerative_mega(
        ref, ref_cam, jnp.arange(W * H, dtype=jnp.uint32),
        jnp.zeros(W * H, jnp.uint32), jnp.uint32(3), interpret=True, **kw)
    got = tmk.trace_regenerative_mega(port, cam, torch.arange(W * H),
                                      torch.zeros(W * H, dtype=torch.int64), 3,
                                      **kw)
    assert len(got) == 4 and got[2].dtype == torch.int32
    assert got[2].shape == (SPP * DEPTH, W * H)
    # The forward bar.
    rad_w, rad_g = jvec3.to_numpy(want[0]), tvec3.to_numpy(got[0])
    assert abs(int(got[1]) - int(want[1])) <= max(4, 0.01 * int(want[1]))
    d = np.abs(rad_g - rad_w)
    assert (d > 2e-2).mean() <= 0.02 and np.median(d) < 1e-5
    # Codes: event and end bit on every row; id and checker bit where live.
    cw, cg = np.asarray(want[2]), got[2].numpy()
    ev_end = ((cw & 7) == (cg & 7)).all(axis=0)
    live = ((cw & 3) == 1) | ((cw & 3) == 2)
    tid_odd = np.where(live, (cw >> 3) == (cg >> 3), True).all(axis=0)
    equal = ev_end & tid_odd
    assert equal.mean() >= 0.98, equal.mean()
    # tprev on the live rows (event or end bit) of equal lanes; the port's
    # rows past a lane's end are zero.
    alive = (cg & 7) != 0
    assert (cg[~alive] == 0).all()
    for tw, tg in zip(want[3], got[3]):
        tw, tg = np.asarray(tw), tg.numpy()
        assert (tg[~alive] == 0).all()
        m = alive & equal[None, :]
        np.testing.assert_allclose(tg[m], tw[m], rtol=0, atol=1e-5)
    assert (cg & 3 == 1).any() and ((cg >> 4) > 0).any()


def test_record_mode_checks_its_bound():
    _, (port, cam) = _both("cornell")
    kw = dict(_record_kw(), record_iters=2)
    # The wrapper (plain version here) and the CUDA launch's preparation
    # both refuse the bound before any work, on every device.
    for entry in (tmk.trace_regenerative_mega, tmk.prepare_launch):
        with pytest.raises(ValueError, match="record_iters"):
            entry(port, cam, torch.arange(W * H),
                  torch.zeros(W * H, dtype=torch.int64), 3, **kw)


# --------------------------------------------------------------------------
# The replay: plain version vs JAX's _traced_bwd on identical residuals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "checker", "mixed",
                                  "many_textures"])
def test_replay_matches_traced_bwd(name):
    (ref, ref_cam), _ = _both(name)
    port, (_, _, codes, tprev) = _port_record(name)
    T = ref.tex_kind.shape[0]
    assert (T > jmd.MAX_TEXTURES) == (name == "many_textures")
    B = W * H
    rng = np.random.default_rng(7)
    ghat = rng.uniform(0.2, 1.0, (3, B)).astype(np.float32)
    codes_np = codes.numpy()
    tprev_np = [t.numpy() for t in tprev]

    res = (jnp.asarray(codes_np), jvec3.V3(*map(jnp.asarray, tprev_np)),
           ref.tex_ca, ref.tex_cb, ref.background, ref, ref_cam,
           jnp.arange(B, dtype=jnp.uint32), jnp.zeros(B, jnp.uint32))
    cfg = (W, H, 1, SPP, DEPTH, 1e-3, SPP * DEPTH, True)
    scene_bar = jmd._traced_bwd(cfg, res,
                                (jvec3.V3(*map(jnp.asarray, ghat)), None))[0]
    got = tmd.replay_backward(codes, tvec3.V3(*tprev),
                              tvec3.V3(*map(torch.from_numpy, ghat)),
                              port.tex_ca, port.tex_cb, port.background,
                              tmd._flags(port))
    for g, key in zip(got, ("tex_ca", "tex_cb", "background")):
        want = np.asarray(getattr(scene_bar, key))
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=key)
    assert np.abs(np.asarray(scene_bar.tex_ca)).max() > 0
    if name in ("checker", "mixed"):
        assert np.abs(np.asarray(scene_bar.tex_cb)).max() > 0


# --------------------------------------------------------------------------
# render_loss and its gradients vs jax.value_and_grad(diff.render_loss)
# --------------------------------------------------------------------------

# (scene, port path, seed): seeds at which both packages trace the same
# paths (checked first in the test; see the module docstring).
LOSS_CASES = [
    ("cornell", "lockstep", 0), ("cornell", "fused", 0),
    ("metal_dielectric", "lockstep", 1), ("metal_dielectric", "fused", 1),
    ("checker", "lockstep", 1), ("checker", "fused", 1),
]


@pytest.mark.parametrize("name,path,seed", LOSS_CASES)
def test_render_loss_matches_jax(name, path, seed, fused_flag):
    """The port's lockstep path against JAX's (its default on the CPU), and
    the port's fused path (its default on every device) against JAX's fused
    path in interpret mode."""
    (ref, ref_cam), (port, cam) = _both(name)
    fused_flag(None if path == "fused" else False,
               True if path == "fused" else None)
    target = np.random.default_rng(seed).uniform(0.0, 0.5, (W * H, 3))
    target = target.astype(np.float32)
    kw = dict(width=W, height=H, spp=SPP, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)

    # Same paths first: per-pixel radiance and segments.
    trainable = tuple(sorted(jdiff.DEFAULT_TRAINABLE))
    acc_w, seg_w = jrender.render_radiance(ref, ref_cam, jnp.uint32(seed),
                                           differentiable=True,
                                           trainable=trainable, **kw)
    acc_g, seg_g = trender.render_radiance(port, cam, seed, differentiable=True,
                                           trainable=trainable, **kw)
    assert int(seg_g) == int(seg_w)
    np.testing.assert_allclose(tvec3.to_numpy(acc_g), jvec3.to_numpy(acc_w),
                               rtol=0, atol=1e-5)

    params, _ = jdiff.split_params(ref)
    loss_w, grads_w = jax.value_and_grad(jdiff.render_loss)(
        params, ref, ref_cam, jnp.asarray(target), jnp.uint32(seed), **kw)
    tparams, _ = diff.split_params(port)
    loss_g, grads_g = diff.render_value_and_grad(
        tparams, port, cam, torch.from_numpy(target), seed, **kw)
    np.testing.assert_allclose(float(loss_g), float(loss_w), rtol=1e-5)
    tol = 2e-4 if name == "cornell" else 3e-4
    assert set(grads_g) == set(grads_w)
    for k in grads_w:
        want, got = np.asarray(grads_w[k]), grads_g[k].numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), k
        scale = max(np.abs(want).max(), 1e-9)
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol,
                                   err_msg=k)
    assert np.abs(grads_g["tex_ca"].numpy()).max() > 0


@pytest.mark.parametrize("name,seed", [("cornell", 0), ("metal_dielectric", 1),
                                       ("checker", 1)])
def test_fused_matches_lockstep(name, seed, fused_flag):
    """The port's fused gradients (K2's and the replay's plain versions on
    the CPU) against its own lockstep autograd path."""
    _, (port, cam) = _both(name)
    kw = dict(width=W, height=H, spp=SPP, samples_per_pass=1, max_depth=DEPTH,
              t_min=1e-3)
    target = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 0.5, (W * H, 3)).astype(np.float32))
    params, _ = diff.split_params(port)
    out = {}
    for fused in (None, False):
        fused_flag(fused)
        acc, segs = trender.render_radiance(
            port, cam, seed, differentiable=True,
            trainable=tuple(sorted(params)), **kw)
        out[fused] = (acc, int(segs)) + diff.render_value_and_grad(
            params, port, cam, target, seed, **kw)
    (acc_f, seg_f, loss_f, g_f), (acc_l, seg_l, loss_l, g_l) = out[None], out[False]
    assert seg_f == seg_l  # the same paths (module docstring)
    np.testing.assert_allclose(tvec3.to_numpy(acc_f), tvec3.to_numpy(acc_l),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss_f), float(loss_l), rtol=1e-5)
    for k in g_l:
        scale = max(float(g_l[k].abs().max()), 1e-9)
        np.testing.assert_allclose(g_f[k].numpy(), g_l[k].numpy(),
                                   atol=2e-4 * scale, rtol=2e-4, err_msg=k)


def test_fused_path_returns_zero_leaves(fused_flag):
    """The fused backward returns zeros, not None, for the declared leaves
    the radiance does not reach (JAX's _zero_cot)."""
    _, (port, cam) = _both("metal_dielectric")
    fused_flag(True)
    leaves = {k: getattr(port, k).clone().requires_grad_(True)
              for k in tmd._LEAVES}
    acc, segs = tmd.radiance_fused(
        port.replace(**leaves), cam, torch.arange(W * H),
        torch.zeros(W * H, dtype=torch.int64), 2, width=W, height=H,
        sample_stride=1, spp_cap=SPP, max_depth=DEPTH, t_min=1e-3)
    assert not segs.requires_grad and int(segs) > 0
    grads = torch.autograd.grad(acc.x.sum() + acc.z.sum(), list(leaves.values()))
    by_name = dict(zip(leaves, grads))
    for k in ("tex_cc", "mat_fuzz", "mat_ir", "atlas"):
        assert by_name[k] is not None and torch.count_nonzero(by_name[k]) == 0
    assert by_name["tex_ca"].abs().max() > 0
    assert by_name["tex_ca"][:, 1].abs().max() == 0  # acc.y is not in the loss


# --------------------------------------------------------------------------
# The gate: supports_diff / enabled parity, and the F2 refusal
# --------------------------------------------------------------------------


def test_gate_matches_jax(monkeypatch, fused_flag):
    cases = [jlib.cornell_box(), jlib.two_spheres(), jlib.two_perlin_spheres(),
             jlib.simple_light(), _metal_scene(), _mixed_scene(),
             _many_textures_scene()]
    # The JAX auto mode also wants a non-CPU backend; the port's gate is the
    # same on every device, so compare with JAX's TPU answer.
    monkeypatch.setattr(jmd.jax, "default_backend", lambda: "tpu")
    trainables = [None, ("tex_ca",), ("tex_ca", "background"),
                  ("tex_ca", "sph_c0"), ("tex_ca", "rect_k"),
                  ("tex_ca", "tri_v0"), tuple(jdiff.DEFAULT_TRAINABLE)]
    verdicts = []
    for ref, params in cases:
        ref_cam = jcam.make_camera(aspect_ratio=1.0, **params)
        port = tscene.scene_from_reference(ref)
        cam = tcam.camera_from_reference(ref_cam)
        for spp, depth in [(SPP, DEPTH), (16, 8), (1000, 50), (32, 8)]:
            sd = tmd.supports_diff(port, cam, spp, 1, depth)
            assert sd == jmd.supports_diff(ref, ref_cam, spp, 1, depth)
            verdicts.append(sd)
            for tr in trainables:
                assert (tmd.enabled(port, cam, spp, 1, depth, trainable=tr)
                        == jmd.enabled(ref, ref_cam, spp, 1, depth,
                                       trainable=tr)), (params, spp, tr)
        fused_flag(True, True)
        for tr in trainables:
            ok = jmd.supports_diff(ref, ref_cam, SPP, 1, DEPTH)
            geom = tr is not None and ({"sph_c0", "rect_k"} & set(tr))
            if ok and not geom:
                assert tmd.enabled(port, cam, SPP, 1, DEPTH, trainable=tr)
            else:
                with pytest.raises(ValueError):
                    tmd.enabled(port, cam, SPP, 1, DEPTH, trainable=tr)
        fused_flag(False, False)
        assert not tmd.enabled(port, cam, SPP, 1, DEPTH, trainable=("tex_ca",))
        fused_flag(None, None)
    assert True in verdicts and False in verdicts
    assert tmd.MAX_RECORD_ITERS == jmd.MAX_RECORD_ITERS
    assert tmd.SAFE_TRAINABLE == jmd.SAFE_TRAINABLE


def test_fused_path_refuses_lane_mask_and_geometry(fused_flag):
    _, (port, cam) = _both("cornell")
    kw = dict(width=W, height=H, sample_start=0, n_samples=SPP, spp_cap=SPP,
              samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
              differentiable=True)
    mask = torch.arange(W * H) % 2 == 0
    with pytest.raises(ValueError, match="F2"):
        trender.radiance_batch(port, cam, torch.arange(W * H), 0,
                               trainable=("tex_ca",), lane_mask=mask, **kw)
    # The lockstep path honours the mask: pad lanes add nothing.
    full, _ = trender.radiance_batch(port, cam, torch.arange(W * H), 0, **kw)
    masked, _ = trender.radiance_batch(port, cam, torch.arange(W * H), 0,
                                       lane_mask=mask, **kw)
    for a, b in zip(full, masked):
        assert torch.all(b[~mask] == 0) and torch.equal(a[mask], b[mask])
    # Forced on, a geometry-trainable loss raises instead of zeroing.
    fused_flag(True)
    params, _ = diff.split_params(port, ("tex_ca", "rect_k"))
    with pytest.raises(ValueError, match="geometry"):
        diff.render_value_and_grad(params, port, cam, torch.zeros(W * H, 3), 0,
                                   width=W, height=H, spp=SPP,
                                   samples_per_pass=1, max_depth=DEPTH,
                                   t_min=1e-3)


# --------------------------------------------------------------------------
# The adam step: state carried across from optax, and the train step
# --------------------------------------------------------------------------


def test_train_state_from_reference_matches_optax():
    rng = np.random.default_rng(3)
    ref, _ = jlib.cornell_box()
    params, _ = jdiff.split_params(ref, ("tex_ca", "background", "mat_fuzz"))
    opt = optax.adam(5e-2)
    state = opt.init(params)
    for _ in range(3):  # a state with history: count 3, non-zero moments
        g = {k: jnp.asarray(rng.normal(size=np.shape(v)), jnp.float32)
             for k, v in params.items()}
        upd, state = opt.update(g, state)
        params = optax.apply_updates(params, upd)
    grads = {k: rng.normal(size=np.shape(v)).astype(np.float32)
             for k, v in params.items()}
    upd, _ = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, state)
    want = optax.apply_updates(params, upd)

    ts = diff.train_state_from_reference(
        {k: np.asarray(v) for k, v in params.items()},
        jax.tree.map(np.asarray, state), 5e-2)
    for k, p in ts.params.items():
        p.grad = torch.from_numpy(grads[k])
    ts.opt_state.step()
    for k, p in ts.params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert diff.params_from_reference(params)["tex_ca"].dtype == torch.float32


def test_make_train_step_lowers_loss():
    port, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    kw = dict(width=W, height=H, spp=SPP, samples_per_pass=1, max_depth=DEPTH)
    with torch.no_grad():
        acc, _ = trender.render_radiance(port, cam, 9, differentiable=True,
                                         t_min=1e-3, **kw)
    target = torch.stack(tuple(acc), dim=1) / SPP
    start = port.replace(tex_ca=port.tex_ca * 1.6, background=port.background + 0.1)
    state, step = diff.make_train_step(start, cam, target, learning_rate=5e-2,
                                       **kw)
    assert isinstance(state.opt_state, torch.optim.Adam)
    losses = []
    for k in range(3):
        state, loss = step(state, 9)
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0], losses
    assert state.params["tex_ca"].grad is not None


def test_bench_prints_its_json_line(monkeypatch):
    # The workload shrunk to a CPU size; the card runs bench.py's own.
    for name, value in (("WIDTH", 12), ("HEIGHT", 9), ("SPP", 2),
                        ("MAX_DEPTH", 3), ("ITERS", 2)):
        monkeypatch.setattr(bench, name, value)
    rec = bench.run("cpu")
    assert rec["metric"] == "cornell_box_fwd_bwd"
    assert rec["unit"] == "Mrays/s/chip" and rec["value"] > 0
    assert rec["wall_ms"] > 0 and rec["segments"] > 0
    assert "vs_baseline" not in rec
