"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX (the GPU machine has none); run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import bvh as bvh_ops
from another_raytracer_tpu_torch.ops import (camera, kernels, render, rng,
                                            shade, vec3)
from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel, mega_diff,
                                                     mega_kernel, perlin_kernel)
from another_raytracer_tpu_torch.utils import imageio

torch.set_num_threads(1)

W, H = 96, 72

pytestmark = pytest.mark.cuda


def _launches(kernel):
    """``kernel``'s launches so far (``ops.kernels.launch_counts``)."""
    return kernels.launch_counts()[kernel]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _metal_scene(device):
    # Lens + motion + metal + dielectric + checker (tests/test_mega.py:53-66).
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(device=device), cam


SCENES = {
    "cornell_box": library.cornell_box,
    "two_spheres": library.two_spheres,
    "lens_motion_metal_dielectric_checker": _metal_scene,
}


def test_threefry_words_bit_exact(dev):
    w = np.random.default_rng(3).integers(0, 2**32, size=(2, 1 << 16),
                                          dtype=np.uint64)
    pix, samp = (torch.from_numpy(x.astype(np.int64)).to(dev) for x in w)
    key1 = (3 << 8) | 2
    (w0, w1), (u0, u1) = mega_kernel.threefry_words_cuda(7, key1, pix, samp)
    r0, r1 = rng.threefry2x32(7, key1, pix, samp, rounds=rng.ROUNDS)
    assert torch.equal(w0, r0) and torch.equal(w1, r1)
    v0, v1 = rng.uniform2_plain(7, pix, samp, 3, 2)
    assert torch.equal(u0, v0) and torch.equal(u1, v1)


def _draw_counters(dev, n, seed):
    """[n] pixel, sample and bounce counters (uint32 words, the extremes
    first; bounces below 2**24) as int64 CUDA tensors."""
    w = np.random.default_rng(seed).integers(0, 2**32, size=(3, n),
                                             dtype=np.uint64)
    k = min(n, 2)
    w[:, :k] = np.array([0, 2**32 - 1], dtype=np.uint64)[:k]
    pix, samp, b = (torch.from_numpy(x.astype(np.int64)).to(dev) for x in w)
    return pix, samp, b & 0xFFFFFF


@pytest.mark.parametrize("n", [1, 6144, 388800])
@pytest.mark.parametrize("bounce_kind", ["int", "tensor"])
@pytest.mark.parametrize("seed_kind", ["int", "tensor"])
def test_draws_kernel_equals_plain(n, bounce_kind, seed_kind, dev):
    """``rng.uniform2`` on CUDA tensors is one launch of the draws kernel,
    bit-equal to the plain int64 code on the card, for every dim the tensor
    paths draw (camera 0, 2, 4; scatter 0, 2; two media)."""
    pix, samp, bounces = _draw_counters(dev, n, n)
    for dim in (0, 2, 4, rng.DIM_MEDIUM, rng.DIM_MEDIUM + 2):
        bounce = rng.CAMERA_BOUNCE if bounce_kind == "int" else bounces
        seed = (0x9E3779B9 if seed_kind == "int"
                else torch.tensor(0x9E3779B9, device=dev))
        before = _launches("draws")
        got = rng.uniform2(seed, pix, samp, bounce, dim)
        assert _launches("draws") == before + 1
        want = rng.uniform2_plain(seed, pix, samp, bounce, dim)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (n,)
            assert torch.equal(g, w), (dim, bounce_kind, seed_kind)


def test_draws_kernel_reads_the_seed_a_graph_replays(dev):
    """Captured in a CUDA graph with a 0-d seed tensor (as the wavefront's
    stages hold it), a replay draws the seed the tensor holds then."""
    pix, samp, bounces = _draw_counters(dev, 6144, 1)
    seed = torch.tensor(11, device=dev)
    rng.uniform2(seed, pix, samp, bounces, 0)  # built and loaded
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rng.uniform2(seed, pix, samp, bounces, rng.DIM_SCATTER_B)
    for s in (12, 0xFFFFFFFF, 11):
        seed.fill_(s)
        graph.replay()
        want = rng.uniform2_plain(s, pix, samp, bounces, rng.DIM_SCATTER_B)
        torch.cuda.synchronize(dev)
        assert all(torch.equal(g, w) for g, w in zip(out, want)), s


def test_draws_kernel_refuses_what_it_does_not_take(dev):
    """int32 or non-contiguous counters, a bounce or a seed of another
    shape or type: the wrapper raises, with no fallback."""
    pix, samp, bounces = _draw_counters(dev, 256, 2)
    before = _launches("draws")
    with pytest.raises(TypeError):
        rng.uniform2(3, pix.to(torch.int32), samp, 1, 0)
    with pytest.raises(ValueError):
        rng.uniform2(3, pix[::2], samp[::2], 1, 0)
    with pytest.raises(ValueError):
        rng.uniform2(3, pix, samp, bounces[:128], 0)
    with pytest.raises(ValueError):
        rng.uniform2(3, pix, samp.cpu(), 1, 0)
    with pytest.raises(TypeError):
        rng.uniform2(torch.tensor([3], device=dev), pix, samp, 1, 0)
    assert _launches("draws") == before


@pytest.mark.parametrize("name,held", [("mesh", 1), ("final_scene", 2)])
def test_stage_graphs_hold_the_draw_launches(name, held, capsule_obj, dev,
                                             monkeypatch):
    """A captured stage's graphs hold one draws launch per ``rng.uniform2``
    call of an iteration.  Through the bounce kernel: none, and no graph B
    (the kernel draws its media's, scatter A's and B's uniforms and the
    re-armed lanes' camera draws itself, in its one launch).  Through the
    eager step: graph B, the re-arm, holds the camera's, the capsule (no
    motion) 1 (the jitter), scene 8 (motion) 2 (the jitter and the shutter
    time)."""
    import collections

    from another_raytracer_tpu_torch.ops import integrator

    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1024)
    scene, params = _media_scenes(capsule_obj)[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp0 = torch.zeros_like(pix)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=4, spp_cap=4,
              max_depth=8, t_min=1e-3)

    def first_stage():
        monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
        for seed in (5, 6):
            integrator.trace_regenerative(scene, cam, pix, samp0, seed, **kw)
        stage = next(iter(integrator._stages.values()))
        assert stage.mode == "replay"
        return stage

    stage = first_stage()
    assert stage.rearm is None and stage._step.rearms
    assert stage.step.held["draws"] == 0 and stage.step.held["bounce"] == 1
    monkeypatch.setattr(integrator, "_regen_step_parts",
                        integrator._eager_step_parts)
    stage = first_stage()
    assert stage.rearm.held["draws"] == held == 1 + scene.has_motion
    assert stage.rearm.held["bounce"] == 0


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_matches_plain(name, dev):
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=8, spp_cap=8,
              max_depth=50, t_min=1e-3)
    before = _launches("K1")
    got, got_segs = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp,
                                                        3, **kw)
    assert _launches("K1") == before + 1
    want, want_segs = mega_kernel.trace_regenerative_mega_reference(
        scene, cam, pix, samp, 3, **kw)
    got, want = vec3.to_numpy(got), vec3.to_numpy(want)
    assert np.isfinite(got).all()
    # The bar of tests/test_mega.py:37-45: nvcc's FMA contraction moves
    # results by ulps, which flips a path now and then at an edge.
    assert abs(int(got_segs) - int(want_segs)) <= max(4, 0.01 * int(want_segs))
    diff = np.abs(got - want)
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5


def _sweep_lanes(dev, n, dead_every=7):
    """n lanes, every ``dead_every``-th born dead (first sample 2**32 - 1)."""
    pix = torch.arange(n, device=dev)
    samp = torch.where(pix % dead_every == 3, 0xFFFFFFFF, 0)
    return pix, samp


@pytest.mark.parametrize("name", list(SCENES))
def test_k1_lane_fetch_equals_the_per_block_mapping(name, dev):
    # Lane fetch changes which thread runs a lane, never the lane: every
    # output is the same bits.  388,800 lanes outnumber the persistent
    # grid's threads, so threads take many lanes each; some are born dead.
    w, h = 720, 540
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=w / h, device=dev, **params)
    pix, samp = _sweep_lanes(dev, w * h)
    kw = dict(width=w, height=h, sample_stride=1, sample_end=2, spp_cap=2,
              max_depth=50, t_min=1e-3)
    outs = []
    for fetch in (False, True):
        run, out = mega_kernel.prepare_launch(scene, cam, pix, samp, 3,
                                              lane_fetch=fetch, **kw)
        assert run() == 0
        outs.append([*out[0], out[1]])
    torch.cuda.synchronize(dev)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[1][3].sum()) > w * h and not bool(outs[1][3][3::7].any())


@pytest.mark.parametrize("fetch", [False, True])
@pytest.mark.parametrize("name", list(SCENES))
def test_sweep_tallies_equal_plain_row_tests(name, fetch, dev):
    # The sweep's counting instance (the record build's arithmetic) tests
    # exactly the plain version's rows, with or without lane fetch, and
    # renders its radiance bit for bit.
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix, samp = _sweep_lanes(dev, W * H)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=4, spp_cap=4,
              max_depth=8, t_min=1e-3)
    rad, segs, t = mega_kernel.sweep_tallies(scene, cam, pix, samp, 3,
                                             lane_fetch=fetch, **kw)
    want = mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp,
                                                         3, work=True, **kw)
    assert (t["sphere_tests"], t["rect_tests"]) == tuple(want[-1])
    assert int(segs) == int(want[1])
    for a, b in zip(rad, want[0]):
        assert torch.equal(a, b)
    assert 0 < t["loop_simt"] <= 1 and 0 <= t["tail_share"] < 1
    assert t["loop_steps"] <= t["loop_active"] <= 32 * t["loop_steps"]
    assert 0 < t["warp_loop_steps_max"] <= t["loop_steps"]


def test_cli_renders_through_the_kernel(dev, tmp_path):
    out = tmp_path / "cornell.png"
    before = _launches("K1")
    assert cli.main(["--scene", "6", "--width", str(W), "--height", str(H),
                     "--spp", "16", "--max-depth", "50", "--mode", "single",
                     "--device", "cuda", "--out", str(out)]) == 0
    assert _launches("K1") == before + 1
    img = imageio.load_png(out)
    assert img.shape == (H, W, 3) and img.mean() > 5.0


def test_spans_on_the_card(dev):
    """Inside a profiler of the card's activity alone (the benchmark's
    traced run), a Cornell render records K1's packing and launch under its
    root and gives the bits it gives unrecorded; a train step records K2's
    packing under its forward."""
    from torch.profiler import ProfilerActivity, profile

    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.utils import profiling

    scene, params = library.cornell_box(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4, max_depth=8,
                       seed=3)
    img, stats = render.render(scene, cam, cfg)
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        img_on, stats_on = render.render(scene, cam, cfg)
    spans = profiling.spans()
    assert np.array_equal(img, img_on) and stats == stats_on
    assert [s.name for s in spans] == [
        "render", "render.pixels", "render.pixels", "mega.prepare",
        "mega.launch", "render.wait"]
    assert all(s.parent == 0 for s in spans[1:])
    assert spans[3].attrs == {"instance": "K1", "lanes": W * H}

    target = torch.full((W * H, 3), 0.5, device=dev)
    state, step = diff.make_train_step(scene, cam, target, width=W, height=H,
                                       spp=4, samples_per_pass=4, max_depth=8)
    profiling.clear_spans()
    with profiling.recording():
        step(state, 1)
    spans = profiling.spans()
    profiling.clear_spans()
    prep = [s for s in spans if s.name == "mega.prepare"]
    assert len(prep) == 1 and prep[0].attrs["instance"] == "K2"
    assert spans[prep[0].parent].name == "train.forward"


def test_trace_scene_spans_on_the_card(dev):
    """``trace_scene --entry`` on the card: the device's idle time of the
    traced renders goes to the port's spans, on the host's clock."""
    from another_raytracer_tpu_torch import trace_scene

    s = trace_scene.trace("cornell", dev, size=(W, H, 4, 8), entry=True)
    idle = {k: v["idle_ms"] for k, v in s["spans"].items()
            if v["idle_ms"] is not None}
    assert set(idle) <= {"render", "render.pixels", "render.wait",
                         "mega.prepare", "mega.launch", trace_scene.OUTSIDE}
    assert idle["mega.prepare"] > 0
    assert sum(idle.values()) == pytest.approx(s["idle_ms"])
    assert 0 < s["idle_ms"] < s["wall_ms"]
    assert s["spans"]["mega.prepare"]["bare_ms"] > 0
    assert len(s["gaps"]) == trace_scene.GAPS


def _record(name, dev, spp=4, depth=8, seed=3):
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=spp, spp_cap=spp,
              max_depth=depth, t_min=1e-3, record_iters=spp * depth)
    before = _launches("K2")
    got = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, seed, **kw)
    assert _launches("K2") == before + 1
    want = mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp,
                                                         seed, **kw)
    return scene, got, want


@pytest.mark.parametrize("name", list(SCENES))
def test_record_kernel_matches_plain(name, dev):
    # The record build contracts no FMA and rounds sin/cos correctly, as the
    # plain version does: the residual rows agree bit for bit.
    _, got, want = _record(name, dev)
    assert int(got[1]) == int(want[1])
    assert torch.equal(got[2], want[2])
    for a, b in zip(got[3], want[3]):
        assert torch.equal(a, b)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert bool(((got[2] & 3) == 1).any())


def _checkers_scene(device):
    # Three checker textures among five on a sweep scene, with metal and a
    # dielectric: three tex_cb rows.
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(
        texture=b.checker_texture((0.8, 0.1, 0.1), (0.1, 0.1, 0.8))))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.sphere((0, 1.0, -1.5), 0.4, b.lambertian(
        texture=b.checker_texture((0.5, 0.9, 0.2), (0.9, 0.9, 0.2))))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=70.0)
    return b.build(device=device), cam


# The replay's scenes by texture count: 4 (Cornell), 21 solid ones (above
# JAX's select-sum limit), and checker textures with their tex_cb rows.
REPLAY_SCENES = dict(SCENES, many_textures=chip_smoke.many_textures_scene,
                     several_checkers=_checkers_scene)


def _replay_args(name, dev):
    scene, params = REPLAY_SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    got = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp, 7, width=W, height=H, sample_stride=1,
        sample_end=4, spp_cap=4, max_depth=8, t_min=1e-3, record_iters=32)
    gen = torch.Generator(device=dev).manual_seed(5)
    ghat = vec3.V3(*(torch.rand(W * H, generator=gen, device=dev) + 0.2
                     for _ in range(3)))
    return (got[2], got[3], ghat, scene.tex_ca, scene.tex_cb,
            scene.background, mega_diff._flags(scene), scene.replay_slots())


@pytest.mark.parametrize("name", list(REPLAY_SCENES))
def test_replay_kernel_matches_plain(name, dev):
    args = _replay_args(name, dev)
    if name == "several_checkers":
        assert args[-1].checkers == 3
    before = _launches("replay")
    kern = mega_diff.replay_backward(*args)
    assert _launches("replay") == before + 1
    plain = mega_diff.replay_backward_reference(*args[:7])
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    assert float(kern[0].abs().max()) > 0
    if args[6] & 1:  # checker textures: their tex_cb rows take gradients
        assert float(kern[1].abs().max()) > 0
    # With a tex_cb row for every texture: the same gradients.
    T = args[3].shape[0]
    every = mega_diff.ReplaySlots(*(torch.arange(T, dtype=torch.int32,
                                                 device=dev),) * 2)
    for a, b in zip(mega_diff.replay_backward(*args[:7], every), plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("name", ["cornell_box", "several_checkers"])
def test_replay_kernel_is_bit_deterministic(name, dev):
    args = _replay_args(name, dev)
    first = mega_diff.replay_backward(*args)
    for _ in range(3):
        for a, b in zip(first, mega_diff.replay_backward(*args)):
            assert torch.equal(a, b)


def test_replay_kernel_reads_separate_planes(dev):
    # tprev as three tensors of their own (not views of one buffer) and a
    # cotangent that is not contiguous (made so): the same gradients as on
    # K2's views.
    args = _replay_args("lens_motion_metal_dielectric_checker", dev)
    want = mega_diff.replay_backward(*args)
    own = vec3.V3(*(t.clone() for t in args[1]))
    assert own.x.untyped_storage().data_ptr() != own.y.untyped_storage().data_ptr()
    wide = vec3.V3(*(torch.stack([t, t], 1)[:, 0] for t in args[2]))
    assert not wide.x.is_contiguous()
    got = mega_diff.replay_backward(args[0], own, wide, *args[3:])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    inputs = mega_diff.replay_inputs(args[0], own, *args[2:6], args[7])
    assert [t.data_ptr() for t in inputs[1:4]] == [t.data_ptr() for t in own]


def test_fused_grads_match_lockstep_on_card(dev):
    scene, params = library.cornell_box(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    kw = dict(width=W, height=H, spp=4, samples_per_pass=1, max_depth=6,
              t_min=1e-3)
    leaves, _ = diff.split_params(scene)
    target = torch.zeros((W * H, 3), device=dev)
    k2 = _launches("K2")
    rp = _launches("replay")
    loss_f, g_f = diff.render_value_and_grad(leaves, scene, cam, target, 4, **kw)
    assert _launches("K2") == k2 + 1
    assert _launches("replay") == rp + 1
    saved = mega_diff.FUSED_DIFF
    mega_diff.FUSED_DIFF = False
    try:
        loss_l, g_l = diff.render_value_and_grad(leaves, scene, cam, target, 4,
                                                 **kw)
    finally:
        mega_diff.FUSED_DIFF = saved
    assert _launches("K2") == k2 + 1
    # Ulp-level differences between the two routes flip a few paths.
    assert abs(float(loss_f) - float(loss_l)) <= 1e-3 * float(loss_l)
    for k in g_l:
        assert torch.isfinite(g_f[k]).all()
        num = float((g_f[k] - g_l[k]).norm())
        assert num <= 1e-2 * max(float(g_l[k].norm()), 1e-30), k


# --------------------------------------------------------------------------
# K5 (BVH closest hit) and K4 (Perlin noise)
# --------------------------------------------------------------------------

# (prim, fold_record, fold_full, precomp): every variant the kernel takes.
BVH_VARIANTS = [("planar", False, False, False), ("planar", False, False, True),
                ("planar", True, False, False), ("planar", True, False, True),
                ("planar", True, True, False), ("planar", True, True, True),
                ("sphere", False, False, False), ("sphere", True, False, False),
                ("rect", False, False, False)]


def _bvh_inputs(prim, n_rays=4096, seed=0):
    g = np.random.default_rng(seed)
    if prim == "planar":
        base = g.uniform(-5, 5, (300, 3))
        v = [base] + [base + g.uniform(-0.6, 0.6, (300, 3)) for _ in range(2)]
        uvs = [g.uniform(0, 1, (300, 2)) for _ in range(3)]
        tree = bvh_lib.build(*bvh_lib.triangle_bounds(*v), leaf_size=16)
        nodes, rows = bvh_kernel.pack_planar(
            tree, *v, np.arange(300) * 4 + 2, uv0=uvs[0], uv1=uvs[1],
            uv2=uvs[2], mats=g.integers(0, 5, 300))
    elif prim == "sphere":
        c0 = g.uniform(-5, 5, (300, 3))
        c1 = c0 + g.uniform(-0.3, 0.3, (300, 3))
        r, t0, t1 = g.uniform(0.2, 0.8, 300), np.zeros(300), np.ones(300)
        tree = bvh_lib.build(*bvh_lib.sphere_bounds(c0, c1, r, t0, t1),
                             leaf_size=16)
        nodes, rows = bvh_kernel.pack_spheres(tree, c0, c1, t0, t1, r,
                                              mats=g.integers(0, 5, 300),
                                              has_uv=np.ones(300))
    else:
        axis = g.integers(0, 3, 300)
        lo = g.uniform(-5, 4, (300, 2))
        k = g.uniform(-5, 5, 300)
        tree = bvh_lib.build(*bvh_lib.rect_bounds(axis, k, lo, lo + 0.8),
                             leaf_size=16)
        nodes, rows = bvh_kernel.pack_rects(tree, axis, k, lo, lo + 0.8,
                                            np.arange(300) * 4 + 1)
    o = g.uniform(-8, 8, (3, n_rays))
    d = g.normal(size=(3, n_rays))
    return (nodes, rows, o.astype(np.float32), d.astype(np.float32),
            g.uniform(0, 1, n_rays).astype(np.float32))


def _bvh_args(prim, dev, n_rays=4096):
    nodes, rows, o, d, time = _bvh_inputs(prim, n_rays)
    n = o.shape[1]
    args = (torch.from_numpy(nodes).to(dev), torch.from_numpy(rows).to(dev),
            vec3.V3(*(torch.from_numpy(c).to(dev) for c in o)),
            vec3.V3(*(torch.from_numpy(c).to(dev) for c in d)),
            torch.full((n,), 3e37, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev))
    return args, dict(leaf_size=16, prim=prim,
                      time=torch.from_numpy(time).to(dev))


def _flat(out):
    return [x for v in out for x in (v if isinstance(v, vec3.V3) else (v,))]


def _launch_flat(args, kw, **launch):
    """One bare launch of K5: its outputs as the wrapper's, flattened."""
    run, (t, code, hit, aux) = bvh_kernel.prepare_launch(*args, **kw,
                                                         **launch)
    assert run() == 0
    return [t, code, hit, *aux]


@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("prim,fold,full,pre", BVH_VARIANTS)
def test_bvh_kernel_matches_plain(prim, fold, full, pre, route, dev):
    """Built without FMA contraction, K5 equals its plain version bit for
    bit (hit mask, code, t and every fold output) on both table routes."""
    args, kw = _bvh_args(prim, dev)
    kw.update(fold_record=fold, fold_full=full, precomp=pre)
    want = _flat(bvh_ops.traverse_packed(*args[:4], kw["time"], 1e-3,
                                         *args[4:], **{
                                             k: v for k, v in kw.items()
                                             if k != "time"}))
    if route == "shared":
        before = _launches("K5")
        got = _flat(bvh_kernel.bvh_closest_hit(*args, **kw))
        assert _launches("K5") == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = _launch_flat(args, kw, t_min=1e-3, route=route)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int(want[2].sum()) < args[2].x.shape[0]


@pytest.mark.parametrize("n", [0, 1, 4096 + 37])
def test_bvh_kernel_at_edge_widths(n, dev):
    """No rays, one ray, and a width that is no multiple of the block."""
    args, kw = _bvh_args("sphere", dev, n_rays=n)
    kw.update(fold_record=True)
    want = _flat(bvh_ops.traverse_packed(
        *args[:4], kw["time"], 1e-3, *args[4:],
        **{k: v for k, v in kw.items() if k != "time"}))
    before = _launches("K5")
    got = _flat(bvh_kernel.bvh_closest_hit(*args, **kw))
    assert _launches("K5") == before + (n > 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for route in ("shared", "global"):
        got = _launch_flat(args, kw, t_min=1e-3, route=route, block=64)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("prim", ["planar", "sphere", "rect"])
def test_bvh_counting_build_equals_plain_counts(prim, dev):
    args, kw = _bvh_args(prim, dev)
    tm = kw.pop("time")
    want = bvh_ops.traverse_packed(*args[:4], tm, 1e-3, *args[4:],
                                   counts=True, **kw)
    t, code, hit, tl = bvh_kernel.tallies(*args, t_min=1e-3, time=tm, **kw)
    assert (tl["slab_tests"], tl["leaf_tests"]) == (
        int(want[-2].sum()), int(want[-1].sum()))
    assert all(torch.equal(a, b) for a, b in zip((t, code, hit), want))
    assert 0 < tl["slab_simt"] <= 1 and 0 < tl["leaf_simt"] <= 1
    assert 0 <= tl["tail_share"] < 1 and tl["blocks"] >= 1


def _noise(dev, q):
    b = SceneBuilder(seed=3)
    for k in range(q):
        b.sphere((0, 0, -k), 1.0,
                 b.lambertian(texture=b.noise_texture((4.0, 0.1, 1.0)[k % 3])))
    return b.build(device=dev)


@pytest.mark.parametrize("n", [0, 1, 257, 1 << 20])
@pytest.mark.parametrize("q", [1, 3])
def test_perlin_kernel_matches_plain(q, n, dev):
    """Bit-equal to the plain version: one table set (no id array) and
    three (an id per point), at small and large magnitude."""
    scene = _noise(dev, q)
    g = np.random.default_rng(1)
    p = np.concatenate([g.uniform(-60, 60, (3, n - n // 2)),
                        g.uniform(-500, 500, (3, n // 2))], 1).astype(np.float32)
    pv = vec3.V3(*(torch.from_numpy(c).to(dev) for c in p))
    ids = torch.from_numpy(g.integers(0, q, n)).to(dev)
    before = _launches("K4")
    got = perlin_kernel.perlin_noise(scene, ids, pv)
    assert _launches("K4") == before + (n > 0)
    assert torch.equal(got, shade.perlin_noise(scene, ids, pv))


def test_cli_renders_bvh_and_noise_scenes_through_the_kernels(dev, tmp_path):
    # Scene 1 takes the megakernel's accel mode (K3), scenes 3 and 5 the
    # wavefront, whose bounce kernel evaluates their noise.
    for scene_id, kernel in (("1", "K3"), ("3", "bounce"), ("5", "bounce")):
        out = tmp_path / f"scene{scene_id}.png"
        before = _launches(kernel)
        assert cli.main(["--scene", scene_id, "--width", str(W), "--height",
                         str(H), "--spp", "4", "--max-depth", "20", "--mode",
                         "single", "--device", "cuda", "--out", str(out)]) == 0
        assert _launches(kernel) > before
        img = imageio.load_png(out)
        assert img.shape == (H, W, 3) and img.mean() > 5.0


# --------------------------------------------------------------------------
# K3 (the megakernel's accel mode) and the large-T replay
# --------------------------------------------------------------------------


# The dense grid holds K3's forward (FMA) build to the test_mega bar where
# crowds of silhouettes and the radius-1000 ground meet.
ACCEL_SCENES = {"random_scene": library.random_scene,
                "bvh_sphere_scene": chip_smoke.bvh_sphere_scene,
                "many_spheres_scene": chip_smoke.many_spheres_scene,
                "dense_spheres_scene": chip_smoke.dense_spheres_scene}


# Where each accel scene's walk reads its tables.
WALKS = {"random_scene": "shared", "bvh_sphere_scene": "shared",
         "many_spheres_scene": "global", "dense_spheres_scene": "global"}


def _accel(name, dev, record_iters=0, spp=4, depth=50):
    scene, params = ACCEL_SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    assert mega_kernel.supports_accel(scene, cam)
    assert mega_kernel.accel_walk(scene) == WALKS[name]
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=spp, spp_cap=spp,
              max_depth=depth, t_min=1e-3, record_iters=record_iters)
    instance = ("K3" + ("_record" if record_iters else "")
                + ("_global" if WALKS[name] == "global" else ""))
    before = kernels.COUNTS.copy()
    got = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, 3, **kw)
    # One launch, counted by its own instance's name and no other.
    assert kernels.COUNTS - before == {instance: 1}
    want = mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp,
                                                         3, **kw)
    return scene, got, want


@pytest.mark.parametrize("name", list(ACCEL_SCENES))
def test_accel_kernel_matches_plain(name, dev):
    _, (got, got_segs), (want, want_segs) = _accel(name, dev)
    got, want = vec3.to_numpy(got), vec3.to_numpy(want)
    assert np.isfinite(got).all() and got.mean() > 0
    # The bar of tests/test_mega.py:37-45 (the forward build contracts FMA).
    assert abs(int(got_segs) - int(want_segs)) <= max(4, 0.01 * int(want_segs))
    diff = np.abs(got - want)
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name", list(ACCEL_SCENES))
def test_accel_record_kernel_matches_plain(name, dev):
    # Built without FMA contraction, K3's record instance equals its plain
    # version bit for bit, as K2 does.
    scene, got, want = _accel(name, dev, record_iters=4 * 8, depth=8)
    assert int(got[1]) == int(want[1])
    assert torch.equal(got[2], want[2])
    for a, b in zip((*got[0], *got[3]), (*want[0], *want[3])):
        assert torch.equal(a, b)
    assert bool(((got[2] & 3) == 1).any())
    if scene.tex_kind.shape[0] > 16:
        assert bool(((got[2] >> 4) > 16).any())


@pytest.mark.parametrize("name", list(ACCEL_SCENES))
def test_walk_tallies_equal_plain_work(name, dev):
    # The counting instance (the record build's arithmetic) walks exactly
    # the plain version's nodes and rows.
    scene, params = ACCEL_SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=4, spp_cap=4,
              max_depth=8, t_min=1e-3)
    rad, segs, t = mega_kernel.walk_tallies(scene, cam, pix, samp, 3, **kw)
    want = mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp,
                                                         3, work=True, **kw)
    assert (t["slab_tests"], t["sphere_tests"]) == tuple(want[-1])
    assert int(segs) == int(want[1])
    for a, b in zip(rad, want[0]):
        assert torch.equal(a, b)
    assert 0 < t["slab_simt"] <= 1 and 0 < t["leaf_simt"] <= 1
    assert 0 < t["ground_tests"] <= t["sphere_tests"]


@pytest.mark.parametrize("name", ["random_scene", "dense_spheres_scene",
                                  "lens_motion_metal_dielectric_checker",
                                  "cornell_box"])
def test_forward_instances_count_sphere_hits(name, dev):
    # K3's and K1's forward instances count their sphere winners on the
    # card as their plain version counts them (its paths to the bar of
    # tests/test_mega.py:37-45: the forward build contracts FMA); a scene
    # without spheres counts none.
    scene, params = {**SCENES, **ACCEL_SCENES}[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=8, spp_cap=8,
              max_depth=50, t_min=1e-3)
    counts = {}
    _, segs = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, 3,
                                                  counts=counts, **kw)
    if not scene.n_spheres:
        assert counts == {} and int(segs) > 0
        return
    want = {}
    mega_kernel.trace_regenerative_mega_reference(scene, cam, pix, samp, 3,
                                                  counts=want, **kw)
    got, want = int(counts["sphere_hits"]), int(want["sphere_hits"])
    assert abs(got - want) <= max(4, 0.01 * want)
    assert 0 < got < int(segs)


def _large_t_replay_args(dev):
    scene, got, _ = _accel("random_scene", dev, record_iters=4 * 8, depth=8)
    T = scene.tex_ca.shape[0]
    slots = scene.replay_slots()
    assert T == 485 and slots.checkers == 1
    assert mega_diff.replay_instance(T, 1)[0] == mega_diff.WARP_TABLES
    gen = torch.Generator(device=dev).manual_seed(5)
    ghat = vec3.V3(*(torch.rand(W * H, generator=gen, device=dev) + 0.2
                     for _ in range(3)))
    return (got[2], got[3], ghat, scene.tex_ca, scene.tex_cb,
            scene.background, mega_diff._flags(scene), slots)


def test_replay_kernel_large_t_matches_plain(dev):
    # The random scene's 485 textures take the per-warp tables; equal to
    # the plain version to float rounding (another order of the sums).
    args = _large_t_replay_args(dev)
    before = _launches("replay")
    kern = mega_diff.replay_backward(*args)
    assert _launches("replay") == before + 1
    plain = mega_diff.replay_backward_reference(*args[:7])
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    assert float(kern[0].abs().max()) > 0 and float(kern[1].abs().max()) > 0


def test_replay_kernel_large_t_is_bit_deterministic(dev):
    # The per-warp tables add in an order fixed by the data: two runs give
    # the same bits (and stay within rtol 1e-5 of the plain version).
    args = _large_t_replay_args(dev)
    first = mega_diff.replay_backward(*args)
    plain = mega_diff.replay_backward_reference(*args[:7])
    for _ in range(3):
        again = mega_diff.replay_backward(*args)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    for a, b in zip(first, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))


def test_fused_grads_on_the_random_scene(dev):
    # T = 485 > 292: the fused path runs K3's record instance and the
    # large-T replay, and agrees with the lockstep autograd path.
    scene, params = library.random_scene(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    kw = dict(width=W, height=H, spp=4, samples_per_pass=1, max_depth=6,
              t_min=1e-3)
    leaves, _ = diff.split_params(scene, ("tex_ca", "tex_cb", "background"))
    target = torch.zeros((W * H, 3), device=dev)
    k3 = _launches("K3_record")
    saved = mega_diff.FUSED_DIFF
    mega_diff.FUSED_DIFF = True
    try:
        loss_f, g_f = diff.render_value_and_grad(leaves, scene, cam, target, 4,
                                                 **kw)
        assert _launches("K3_record") == k3 + 1
        mega_diff.FUSED_DIFF = False
        loss_l, g_l = diff.render_value_and_grad(leaves, scene, cam, target, 4,
                                                 **kw)
    finally:
        mega_diff.FUSED_DIFF = saved
    # Ulp-level differences between the two routes flip a few paths.
    assert abs(float(loss_f) - float(loss_l)) <= 1e-3 * float(loss_l)
    for k in g_l:
        assert torch.isfinite(g_f[k]).all()
        num = float((g_f[k] - g_l[k]).norm())
        assert num <= 1e-2 * max(float(g_l[k].norm()), 1e-30), k


def test_cli_renders_scene1_adaptive(dev, tmp_path):
    out = tmp_path / "scene1.png"
    before = _launches("K3")
    assert cli.main(["--scene", "1", "--width", "96", "--height", "72",
                     "--spp", "4", "--max-depth", "20", "--mode", "adaptive",
                     "--device", "cuda", "--out", str(out)]) == 0
    assert _launches("K3") > before
    img = imageio.load_png(out)
    assert img.shape == (72, 96, 3) and img.mean() > 5.0


# --------------------------------------------------------------------------
# Media and meshes: scenes 7-9 through the wavefront and lockstep paths
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capsule_obj(tmp_path_factory):
    """The 5,760-triangle capsule of chip_smoke.py (64 x 45 quads)."""
    return chip_smoke.write_capsule(str(tmp_path_factory.mktemp("mesh")))


def test_bvh_kernel_on_a_mesh_takes_device_memory(capsule_obj, dev):
    """K5 on the planar tree of a >= 5,000-triangle mesh: its tables do not
    fit shared memory, so the wrapper launches the device-memory walk, bit
    for bit its plain version, in every planar variant."""
    scene, params = library.mesh_scene(obj_path=capsule_obj, device=dev)
    assert scene.n_triangles == 5760 and scene.tri_in_bvh
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    o, d, tm = camera.generate_rays(cam, pix, torch.zeros_like(pix), W, H, 0)
    n = W * H
    args = (scene.bvh_packed_nodes, scene.bvh_packed_tris, o, d,
            torch.full((n,), 3e37, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev))
    for fold, full, pre in chip_smoke.K5_VARIANTS["planar"]:
        kw = dict(leaf_size=scene.bvh_leaf_size, prim="planar", time=tm,
                  fold_record=fold, fold_full=full, precomp=pre)
        tables = scene.k5_tables("planar", pre)
        assert bvh_kernel.table_route(tables) == "global"
        before = kernels.COUNTS.copy()
        got = _flat(bvh_kernel.bvh_closest_hit(*args, tables=tables, **kw))
        assert kernels.COUNTS - before == {"K5/planar/global": 1}
        want = _flat(bvh_ops.traverse_packed(
            *args[:4], tm, 1e-3, *args[4:],
            **{k: v for k, v in kw.items() if k != "time"}))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0 < int(want[2].sum()) < n


def _media_scenes(obj):
    return {"cornell_smoke": library.cornell_smoke,
            "final_scene": library.final_scene,
            "mesh": lambda device: library.mesh_scene(obj_path=obj,
                                                      device=device)}


@pytest.mark.parametrize("name", ["cornell_smoke", "final_scene", "mesh"])
def test_media_wavefront_matches_plain(name, capsule_obj, dev):
    """The wavefront of scenes 7, 8 and a mesh through K5 and the bounce
    kernel, bit-equal to the eager step through K5's, K4's and the draws
    kernel's plain versions; the megakernel launches nothing, and K4
    nothing either (the bounce kernel evaluates scene 8's noise itself)."""
    scene, params = _media_scenes(capsule_obj)[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    kw = dict(width=W, height=H, sample_start=0, n_samples=2, spp_cap=2,
              samples_per_pass=1, max_depth=8, t_min=1e-3)
    pix = torch.arange(W * H, device=dev)
    chip_smoke.reset_counts()
    got, got_segs = render.radiance_batch(scene, cam, pix, 5, **kw)
    launched = chip_smoke.counts()
    with chip_smoke.plain_wavefront():
        want, want_segs = render.radiance_batch(scene, cam, pix, 5, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got_segs) == int(want_segs) > W * H
    assert launched["K1"] == launched["K3"] == launched["K3_global"] == 0
    trees = {"cornell_smoke": set(), "final_scene": {"rect/shared",
                                                     "sphere/shared"},
             "mesh": {"planar/global"}}[name]
    assert set(launched["K5_by_tree"]) == trees
    assert launched["K4"] == 0 and launched["bounce"] > 0


def test_media_gradient_is_finite_on_the_card(dev):
    """A lockstep gradient step on scene 7 with the media densities
    trainable (media never take the fused path).  Its media have solid
    albedos, so the radiance is piecewise constant in the densities and the
    gradient is zero, as in the JAX package; a noise-textured medium's is
    not."""
    scene, params = library.cornell_smoke(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    target = torch.full((W * H, 3), 0.2, device=dev)
    before = _launches("replay")
    loss, grads = diff.render_value_and_grad(
        {"med_neg_inv_density": scene.med_neg_inv_density}, scene, cam,
        target, 1, width=W, height=H, spp=2, samples_per_pass=1, max_depth=6,
        t_min=1e-3)
    g = grads["med_neg_inv_density"]
    assert g.device.type == "cuda" and bool(torch.isfinite(loss))
    assert bool(torch.isfinite(g).all())
    assert _launches("replay") == before
    b = SceneBuilder(background=(0.0, 0.0, 0.0), seed=12)
    b.xz_rect(-30, 30, -30, 30, 6, b.diffuse_light(color=(2, 2, 2)))
    b.constant_medium_box((-3, -2, -6), (3, 2, -2), 0.4,
                          texture=b.noise_texture(1.3))
    noisy = b.build(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, lookfrom=(0, 0.3, 2),
                             lookat=(0, 0, -4), vfov=50.0)
    _, grads = diff.render_value_and_grad(
        {"med_neg_inv_density": noisy.med_neg_inv_density}, noisy, cam,
        target, 1, width=W, height=H, spp=2, samples_per_pass=1, max_depth=4,
        t_min=1e-3)
    g = grads["med_neg_inv_density"]
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


GRAPH_SCENES = ("random_scene", "two_spheres", "two_perlin_spheres", "earth",
                "simple_light", "cornell_box", "cornell_smoke", "final_scene",
                "mesh")


@pytest.mark.parametrize("name", GRAPH_SCENES)
def test_wavefront_graphs_equal_eager(name, capsule_obj, dev, monkeypatch):
    """Every scene of the library and the capsule through the wavefront's
    CUDA graphs, in stages of 13,824, 1,792 and 256 lanes (the first with
    K5's folded record): the same images, segments and launch counts as
    the eager body, on the render that captures, on renders with another
    seed that replay, and after an eviction."""
    import collections

    from another_raytracer_tpu_torch.ops import integrator, intersect
    from another_raytracer_tpu_torch.utils import profiling

    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1024)
    monkeypatch.setattr(intersect, "FOLD_RECORD_MIN_B", 8192)
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", 8192)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    widths = integrator._stage_widths(2 * W * H)
    assert widths == [13824, 1792, 256]
    scenes = dict(_media_scenes(capsule_obj),
                  **{k: getattr(library, k) for k in GRAPH_SCENES[:-1]})
    scene, params = scenes[name](device=dev)
    end = 4
    if name == "earth":
        # A path meets the globe once, then the sky: a lane on the globe
        # runs twice the iterations of one on the sky.  At 60 degrees the
        # globe's lanes (~4%) are few enough to go on in the second stage,
        # and with six samples each stage runs three iterations.
        params, end = dict(params, vfov=60.0), 6
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    # Lane s * W * H + p: pixel p from sample s, stride 2, ``end`` samples.
    pix = torch.arange(W * H, device=dev).repeat(2)
    samp0 = torch.arange(2, device=dev).repeat_interleave(W * H)

    def run(seed):
        chip_smoke.reset_counts()
        profiling.clear_spans()
        with profiling.recording():
            acc, segs = integrator.trace_regenerative(
                scene, cam, pix, samp0, seed, width=W, height=H,
                sample_stride=2, sample_end=end, spp_cap=end, max_depth=8,
                t_min=1e-3)
        modes = [(s.attrs["width"], s.attrs["graph"])
                 for s in profiling.spans() if s.name == "wavefront.iteration"]
        profiling.clear_spans()
        counts = dict(chip_smoke.counts(),
                      K4_points=kernels.COUNTS["K4.points"])
        return torch.stack(tuple(acc)), int(segs), counts, modes

    with monkeypatch.context() as m:
        m.setattr(integrator, "GRAPHS", {})
        want = {seed: run(seed) for seed in (5, 6)}
    # The Cornell box's paths all run to the depth cap: its survivors die
    # at once and no later stage iterates.
    ran = {w for w, _ in want[5][3]}
    assert widths[0] in ran and (len(ran) >= 2 or name == "cornell_box")

    def same(got, seed):
        img, segs, counts, _ = want[seed]
        assert torch.equal(got[0], img) and got[1] == segs
        assert got[2] == counts

    first = run(5)
    same(first, 5)
    assert {m for _, m in first[3]} == {"eager", "capture", "replay"}
    kept = first[0].clone()
    # A stage that ran one iteration on the first render captures on the
    # second; by the third every stage replays.
    for seed, modes in ((6, {"capture", "replay"}), (5, {"replay"})):
        got = run(seed)
        same(got, seed)
        seen = {m for _, m in got[3]}
        assert seen <= modes and "replay" in seen
    assert torch.equal(first[0], kept)

    monkeypatch.setattr(integrator, "GRAPH_CACHE_SIZE", 1)
    integrator._stages.clear()
    got = run(6)
    same(got, 6)
    assert "capture" in {m for _, m in got[3]}
    assert len(integrator._stages) == 1


def test_wavefront_graphs_count_sphere_hits_like_eager(dev, monkeypatch):
    """The ``render`` span's ``sphere_hits`` (the wavefront's sphere winners,
    counted on the card) through the CUDA graphs, on a render that captures
    and on one that replays, equal the eager body's; the images and
    segments too."""
    import collections

    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import integrator
    from another_raytracer_tpu_torch.utils import profiling

    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1024)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    scene, params = library.two_perlin_spheres(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)

    def run(seed):
        profiling.clear_spans()
        with profiling.recording():
            img, stats = render.render(scene, cam, RenderConfig(
                width=W, height=H, samples_per_pixel=4, max_depth=8,
                seed=seed))
        roots = [s for s in profiling.spans() if s.name == "render"]
        modes = {s.attrs["graph"] for s in profiling.spans()
                 if s.name == "wavefront.iteration"}
        profiling.clear_spans()
        return img, stats, roots[0].attrs, modes

    with monkeypatch.context() as m:
        m.setattr(integrator, "GRAPHS", {})
        want = {seed: run(seed) for seed in (5, 6)}
    for seed in (5, 6, 5):
        img, stats, attrs, modes = run(seed)
        assert np.array_equal(img, want[seed][0]) and stats == want[seed][1]
        assert attrs == want[seed][2]
        assert 0 < attrs["sphere_hits"] < attrs["segments"]
    assert "replay" in modes


def test_host_library_builds_and_decodes_a_jpeg(dev):
    """The host library (csrc/host) builds on the card's machine and decodes
    the committed samples bit for bit as their stored native decodes, and
    the tinted ones within the PIL bar of their stored PIL decodes."""
    from pathlib import Path

    from another_raytracer_tpu_torch.utils import native

    path, _ = native.build()
    assert path.exists()
    samples = Path(native.__file__).resolve().parent / "jpeg_samples"
    for name in ("baseline_420", "progressive", "chroma_420",
                 "chroma_progressive"):
        got = native.decode_jpeg(samples / f"{name}.jpg")
        np.testing.assert_array_equal(
            got, imageio.load_png(samples / f"{name}.native.png"))
        if (samples / f"{name}.png").exists():
            d = np.abs(got.astype(int)
                       - imageio.load_png(samples / f"{name}.png").astype(int))
            assert d.max() <= 4 and d.mean() < 0.1, name


def test_stripes_over_one_card_equal_one_launch(dev):
    """K1 over [cuda:0] x 4 stripes: each shard one launch, the radiance bit
    for bit the single launch's; an all-dead sample shard returns zeros."""
    from another_raytracer_tpu_torch.parallel import sharding

    scene, params = library.cornell_box(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    kw = dict(width=W, height=H, spp=4, samples_per_pass=1, max_depth=8,
              t_min=1e-3)
    ref, ref_segs = render.render_radiance(scene, cam, 2, **kw)
    before = _launches("K1")
    part = sharding.hybrid_partition(4, 1, devices=[dev] * 4)
    acc, segs = sharding.render_radiance_sharded(scene, cam, 2, partition=part,
                                                 **kw)
    assert _launches("K1") == before + 4
    assert all(torch.equal(a, b) for a, b in zip(acc, ref))
    assert int(segs) == int(ref_segs)
    out, seg = render.radiance_batch(
        scene, cam, torch.arange(W * H, device=dev), 2, width=W, height=H,
        sample_start=4, n_samples=1, spp_cap=4, samples_per_pass=1,
        max_depth=8, t_min=1e-3)
    assert int(seg) == 0 and all(bool((c == 0).all()) for c in out)


def test_cornell_demo_matches_plain_versions(dev):
    """The Cornell demo's first 3 steps at its chip configuration: on the
    card (one K2 and one replay launch a step) against the same on the
    CPU's plain versions.  The floor and each step's loss, each leaf's
    gradient at each step, and after the steps each leaf's change from its
    start, agree within 1e-3 of their scale.  The gradients are held
    themselves, since adam's update hardly depends on a gradient's scale.
    The bar is above rounding's: the card's and the CPU's math functions
    may differ by an ulp, which can part a grazing path, and one pixel of
    the 24,300 is ~4e-5 of the loss (an H100 gave 3.9e-5 for a loss,
    1.8e-4 for a gradient and 2.7e-4 for the change); a kernel that is
    wrong anywhere shows at O(1)."""
    from another_raytracer_tpu_torch import train_demo

    def worst(got, want):
        return max(float((got[k].detach().cpu() - want[k]).abs().max())
                   / max(float(want[k].abs().max()), 1e-30) for k in want)

    card = train_demo.cornell_demo(dev)
    plain = train_demo.cornell_demo("cpu")
    start = {k: v.detach().clone() for k, v in plain.params.items()}
    seen = {"floor": abs(card.floor - plain.floor) / plain.floor}
    kernels.reset_launch_counts()
    for k in range(3):
        got, want = float(card.step(k)), float(plain.step(k))
        seen[f"loss {k}"] = abs(got - want) / abs(want)
        seen[f"grad {k}"] = worst(
            {n: p.grad for n, p in card.params.items()},
            {n: p.grad for n, p in plain.params.items()})
    launched = kernels.launch_counts()
    seen["change"] = worst({n: card.params[n].detach().cpu() - start[n]
                            for n in start},
                           {n: plain.params[n].detach() - start[n]
                            for n in start})
    print("card vs plain, over scale:", seen)  # shown by pytest -rP
    assert (launched["K2"], launched["replay"]) == (3, 3)
    assert max(seen.values()) <= 1e-3, seen
