"""The bounce kernel (``csrc/bounce_kernel.cu``) against the wavefront's
eager step on the card, bit for bit.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX (the GPU machine has none); run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bounce_cuda.py -q

Each step compares the kernel step (``integrator._kernel_step_parts``: K5
over the trees, then the kernel, which re-arms the lanes whose paths end)
with the eager step followed by its re-arm
(``integrator._eager_step_parts``: the same K5, K4 and draws kernels and
PyTorch's ops; the re-arm ``camera.generate_rays``) on one carry: the whole
next carry, the segments and the sphere winners.  The scenes hold every
primitive, material, texture and medium kind between them, and cameras
with and without a thin lens and a shutter; the widths take each of K5's
record folds (planar, sphere) and none.
"""

import collections

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import (camera, integrator, intersect,
                                            kernels, render)

pytestmark = pytest.mark.cuda

W, H = 64, 32
T_MIN = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bench_scene(name, tmp, device):
    """A benchmark configuration's scene and camera parameters."""
    import json

    from benchmark import harness, inputs, scenes

    cfg = json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, str(tmp)), W, H,
                              device)
    return scene, cam


def _metal_scene(device):
    # Lens, motion, metal, dielectric, checker (test_torch_cuda.py's).
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


def _triangle_scene(device):
    """Swept triangles under a rotation (no tree takes them), a barycentric
    and an image texture, a transformed sphere, a medium box and a light."""
    rng = np.random.default_rng(4)
    b = SceneBuilder(background=(0.2, 0.3, 0.4), seed=9)
    xf = b.transform(rotate_y_deg=25.0, translate=(0.3, 0.0, -0.2))
    bary = b.lambertian(texture=b.barycentric_texture((1, 0, 0), (0, 1, 0),
                                                      (0, 0, 1)))
    img = b.lambertian(texture=b.image_texture(
        rng.uniform(0, 1, (8, 16, 3))))
    for k in range(12):
        c = rng.uniform(-1.5, 1.5, 3) * (1, 0.5, 0.3) - (0, 0, 2)
        v = [tuple(c + rng.uniform(-0.6, 0.6, 3)) for _ in range(3)]
        b.triangle(*v, bary if k % 2 else img,
                   uvs=((0, 0), (1, 0), (0.5, 1)), xform=xf)
    b.sphere((0.0, -50.8, -2.0), 50, b.metal((0.7, 0.7, 0.7), 0.1), xform=xf)
    b.constant_medium_box((-0.5, -0.5, -3.0), (0.5, 0.5, -2.5), 0.8,
                          color=(0.9, 0.9, 0.9), xform=xf)
    b.xy_rect(-1, 1, -1, 1, -5, b.diffuse_light(color=(3, 3, 3)))
    return b.build(device=device), dict(lookfrom=(0, 0.3, 1.5),
                                        lookat=(0, 0, -2), vfov=60.0)


LIBRARY = {
    "random_scene": library.random_scene,
    "two_perlin_spheres": library.two_perlin_spheres,
    "earth": library.earth,
    "simple_light": library.simple_light,
    "cornell_smoke": library.cornell_smoke,
    "lens_motion_metal_dielectric_checker": _metal_scene,
    "triangles": _triangle_scene,
}
BENCH = ("mesh_capsule", "final_scene")


def _scene(name, tmp, device):
    if name in BENCH:
        scene, cam = _bench_scene(name, tmp, device)
        return scene, cam
    scene, params = LIBRARY[name](device=device)
    return scene, camera.make_camera(aspect_ratio=W / H, device=device,
                                     **params)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    """Bit for bit (NaN payloads included)."""
    return a.shape == b.shape and bool(torch.equal(_bits(a), _bits(b)))


def _diff(a, b):
    """Where ``a`` and ``b`` part: the lanes and the largest gap."""
    ne = _bits(a) != _bits(b)
    lanes = torch.nonzero(ne).flatten()[:4].tolist()
    gap = float((a.double() - b.double()).abs().nan_to_num(0).max())
    return (f"{int(ne.sum())} lanes differ, first {lanes}: "
            f"{a[lanes].tolist()} vs {b[lanes].tolist()}, largest gap {gap}")


def _flat(state):
    return integrator._flatten(state)


def _check_steps(scene, cam, width, spp, dev, iters=7, seed=11,
                 max_depth=8):
    """``iters`` steps of a ``width``-lane stage (``spp`` lanes a pixel):
    the kernel step against the eager step followed by its re-arm on each
    carry the eager loop reaches, in new tensors and in place, with the
    sphere winners and the medium scatters each counts.  Returns how many
    lanes were alive, hit a sphere, scattered in a medium and re-armed,
    summed over the steps."""
    n_pix = width // spp
    pix = (torch.arange(width, device=dev) % n_pix)
    samp0 = torch.arange(width, device=dev) // n_pix
    args = (scene, cam, pix, seed, W, H, spp, 3 * spp, max_depth, T_MIN)
    k_hits, e_hits, k_scat, e_scat = (
        torch.zeros((), dtype=torch.int64, device=dev) for _ in range(4))
    cam_rays, k_step, k_rearm = integrator._kernel_step_parts(*args, k_hits,
                                                              k_scat)
    _, e_step, e_rearm = integrator._eager_step_parts(*args, e_hits, e_scat)
    assert k_step.kind == "kernel" and e_step.kind == "eager"
    assert k_step.rearms and k_rearm is None and not e_step.rearms
    state = integrator._regen_initial_state(cam_rays, samp0, 3 * spp)
    seen = collections.Counter()
    for it in range(iters):
        before = kernels.COUNTS["bounce"]
        got, g_regen, g_any = k_step(state)
        assert kernels.COUNTS["bounce"] == before + 1
        assert g_regen is None and g_any is None
        want, w_regen, w_any = e_step(state)
        if bool(w_any):
            want = e_rearm(want, w_regen)
        for k, (a, b) in enumerate(zip(_flat(got), _flat(want))):
            assert _same(a, b), f"step {it}: carry tensor {k}: {_diff(a, b)}"
        assert int(k_hits) == int(e_hits)
        assert int(k_scat) == int(e_scat)
        # In place, into a copy of the carry: the same bits.
        bufs = [t.clone() for t in _flat(state)]
        carry = integrator._unflatten(bufs)
        new, _, _ = k_step(carry, into=carry)
        assert all(a is b for a, b in zip(_flat(new), bufs))
        for k, (a, b) in enumerate(zip(bufs, _flat(want))):
            assert _same(a, b), f"step {it}: in place, tensor {k} differs"
        k_hits.copy_(e_hits)
        k_scat.copy_(e_scat)
        seen["alive"] += int(state[6].sum())
        seen["regen"] += int(w_regen.sum())
        state = want
    seen["sphere_hits"] = int(e_hits)
    seen["medium_scatters"] = int(e_scat)
    return seen


@pytest.mark.parametrize("fold", ["record", "none"])
@pytest.mark.parametrize("name", BENCH + tuple(LIBRARY))
def test_kernel_step_equals_eager_step(name, fold, dev, tmp_path,
                                       monkeypatch):
    """The kernel step's carry, segments and sphere winners equal the eager
    step's followed by its re-arm, step by step, at a width where K5 folds
    its winner record ("record": 8,192 lanes with the gates lowered to 4,096)
    and one where it does not (2,048 lanes); lanes re-arm in the steps.
    Scene 8, scene 1 (``random_scene``) and the metal scene take the
    shutter, the last two the thin lens too."""
    monkeypatch.setattr(intersect, "FOLD_RECORD_MIN_B", 4096)
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", 4096)
    scene, cam = _scene(name, tmp_path, dev)
    width = 8192 if fold == "record" else 2048
    seen = _check_steps(scene, cam, width, width // (W * H), dev)
    assert seen["alive"] > 0 and seen["regen"] > 0
    want_fold = ({"mesh_capsule": "planar", "final_scene": "sphere",
                  "random_scene": "sphere"}.get(name)
                 if fold == "record" else None)
    assert intersect.fold_tree(scene, width) == want_fold


def test_kernel_step_at_the_benchmark_widths(dev, tmp_path):
    """The capsule's and scene 8's first stage at the real gates: 388,800
    lanes (720 x 540, the planar and the sphere fold) and the narrow stage
    of 6,144 lanes (no fold)."""
    for name, want in (("mesh_capsule", "planar"), ("final_scene", "sphere")):
        scene, cam = _scene(name, tmp_path / name, dev)
        assert intersect.fold_tree(scene, 388800) == want
        assert intersect.fold_tree(scene, 6144) is None
        _check_steps(scene, cam, 388800, 400, dev, iters=3)
        _check_steps(scene, cam, 6144, 3, dev, iters=3)


def test_tree_less_media_step_at_the_cell_s_width(dev, tmp_path):
    """Scene 7 as ``cornell_smoke.render`` runs it: no tree, so the step is
    the bounce kernel's tree-less media instance alone (its own rect sweep
    finds the winner), at the cell's 388,800 lanes and a narrow stage's
    6,144; the carry bit for bit and the medium scatters equal to the
    eager step's, which counts them with tensor ops."""
    scene, cam = _bench_scene("cornell_smoke", tmp_path, dev)
    assert not scene.has_accel and scene.n_media == 2
    assert intersect.fold_tree(scene, 388800) is None
    for width, spp in ((388800, 400), (6144, 3)):
        before = kernels.launch_counts()
        seen = _check_steps(scene, cam, width, spp, dev, iters=4,
                            max_depth=50)
        after = kernels.launch_counts()
        assert after["K5"] == before["K5"] and after["K4"] == before["K4"]
        assert seen["medium_scatters"] > 0 and seen["sphere_hits"] == 0
        assert seen["regen"] > 0


def test_scene_7_render_launches_no_tree_kernel(dev, tmp_path, monkeypatch):
    """A render of ``cornell_smoke`` at the cell's 720 x 540 (spp 2) through
    ``ops.render.render``: no K5, K4 or megakernel launch, one bounce launch
    an iteration, one draws launch (the first camera rays, before the
    loop), and on the render after the warm one every iteration
    replays its stage's graph A, which holds the bounce kernel alone; the
    span's medium scatters equal the eager render's and the image and
    segments its bits."""
    import json

    from benchmark import harness, inputs, scenes
    from another_raytracer_tpu_torch.utils import profiling

    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    cfg = json.loads((harness.ROOT / "configs"
                      / "cornell_smoke.json").read_text())
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, str(tmp_path)),
                              720, 540, dev)
    config = RenderConfig(width=720, height=540, samples_per_pixel=2,
                          max_depth=50, seed=3_000_000_001)

    def run():
        profiling.clear_spans()
        with profiling.recording():
            img, stats = render.render(scene, cam, config)
        spans = profiling.spans()
        profiling.clear_spans()
        root = [s for s in spans if s.name == "render"][0]
        its = [s for s in spans if s.name == "wavefront.iteration"]
        return img, stats, root.attrs, its

    render.render(scene, cam, config)  # captures
    kernels.reset_launch_counts()
    img, stats, attrs, its = run()
    launched = kernels.launch_counts()
    assert launched["bounce"] == len(its) > 0
    assert all(launched[k] == 0 for k in ("K1", "K3", "K5", "K4"))
    assert launched["draws"] == 1
    assert {s.attrs["graph"] for s in its} == {"replay"}
    for st in integrator._stages.values():
        assert st.rearm is None and st.step.held["bounce"] == 1
        assert st.step.held["K5"] == st.step.held["draws"] == 0
    assert 0 < attrs["medium_scatters"] < attrs["segments"]
    with monkeypatch.context() as m:
        m.setattr(integrator, "_regen_step_parts",
                  integrator._eager_step_parts)
        m.setattr(integrator, "_stages", collections.OrderedDict())
        want, want_stats, want_attrs, _ = run()
    assert np.array_equal(img, want) and stats == want_stats
    assert attrs == want_attrs


@pytest.mark.parametrize("name", BENCH)
def test_graph_replay_equals_eager(name, dev, tmp_path, monkeypatch):
    """The wavefront through the stages' CUDA graphs (every step one K5
    chain and one bounce launch) equals the same without graphs, on a
    render that captures and on renders that replay; each stage's step
    graph holds one bounce launch."""
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1024)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    scene, cam = _scene(name, tmp_path, dev)
    pix = torch.arange(W * H, device=dev).repeat(2)
    samp0 = torch.arange(2, device=dev).repeat_interleave(W * H)
    kw = dict(width=W, height=H, sample_stride=2, sample_end=6, spp_cap=6,
              max_depth=8, t_min=T_MIN)

    def run(seed):
        acc, segs = integrator.trace_regenerative(scene, cam, pix, samp0,
                                                  seed, **kw)
        return torch.stack(tuple(acc)), int(segs)

    with monkeypatch.context() as m:
        m.setattr(integrator, "GRAPHS", {})
        want = {seed: run(seed) for seed in (5, 6)}
    for seed in (5, 6, 5):
        img, segs = run(seed)
        assert _same(img, want[seed][0]) and segs == want[seed][1]
    modes = {st.mode for st in integrator._stages.values()}
    assert "replay" in modes
    for st in integrator._stages.values():
        if st.mode == "replay":
            assert st.step.held["bounce"] == 1
            assert st.step.held["draws"] == st.step.held["K4"] == 0


@pytest.mark.parametrize("name", BENCH)
def test_warm_wavefront_reads_the_alive_count_alone(name, dev, tmp_path,
                                                    monkeypatch):
    """A warmed ``trace_regenerative`` on the capsule and scene 8: every
    iteration replays graph A alone, whose bounce kernel re-armed the
    lanes (``rearm`` "kernel"), no stage holds a graph B, and the
    ``wavefront.wait`` spans number the iterations, the stages and the
    compactions.  The image and segments equal the eager step's with its
    re-arm through graphs A and B, which reads twice an iteration."""
    from another_raytracer_tpu_torch.utils import profiling

    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1024)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    scene, cam = _scene(name, tmp_path, dev)
    pix = torch.arange(W * H, device=dev).repeat(2)
    samp0 = torch.arange(2, device=dev).repeat_interleave(W * H)
    kw = dict(width=W, height=H, sample_stride=2, sample_end=6, spp_cap=6,
              max_depth=8, t_min=T_MIN)

    def warm_run():
        for seed in (5, 6):  # the first captures, the second replays
            integrator.trace_regenerative(scene, cam, pix, samp0, seed, **kw)
        profiling.clear_spans()
        with profiling.recording():
            acc, segs = integrator.trace_regenerative(scene, cam, pix, samp0,
                                                      7, **kw)
        spans = profiling.spans()
        profiling.clear_spans()
        its = [s for s in spans if s.name == "wavefront.iteration"]
        waits = sum(s.name == "wavefront.wait" for s in spans)
        stages = sum(s.attrs["stages"] for s in spans
                     if s.name == "wavefront")
        compactions = sum(s.name == "wavefront.compact" for s in spans)
        assert its and stages >= 2 and compactions == stages - 1
        return (torch.stack(tuple(acc)), int(segs), its,
                waits - stages - compactions)

    img, segs, its, reads = warm_run()
    assert {(s.attrs["graph"], s.attrs["step"], s.attrs["rearm"])
            for s in its} == {("replay", "kernel", "kernel")}
    assert reads == len(its)
    for st in integrator._stages.values():
        assert st.rearm is None and st.step.held["bounce"] == 1
        assert st.step.held["draws"] == 0

    with monkeypatch.context() as m:
        m.setattr(integrator, "_regen_step_parts",
                  integrator._eager_step_parts)
        m.setattr(integrator, "_stages", collections.OrderedDict())
        want_img, want_segs, want_its, want_reads = warm_run()
    assert _same(img, want_img) and segs == want_segs
    assert len(its) == len(want_its) and want_reads == 2 * len(want_its)
    assert {s.attrs["rearm"] for s in want_its} == {"ops", "none"}


@pytest.mark.parametrize("name", BENCH + ("cornell_smoke",))
def test_render_equals_the_eager_step(name, dev, tmp_path, monkeypatch):
    """A 160 x 120 render through the kernel step (graphs on) gives the
    image and segments of the same render through the eager step."""
    import json

    from benchmark import harness, inputs, scenes

    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    if name in BENCH:
        cfg = json.loads((harness.ROOT / "configs"
                          / f"{name}.json").read_text())
        scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, str(tmp_path)),
                                  160, 120, dev)
    else:
        scene, params = library.cornell_smoke(device=dev)
        cam = camera.make_camera(aspect_ratio=160 / 120, device=dev, **params)
    config = RenderConfig(width=160, height=120, samples_per_pixel=4,
                          max_depth=8, seed=3_000_000_001)
    kernels.reset_launch_counts()
    img, stats = render.render(scene, cam, config)
    launched = kernels.launch_counts()
    assert launched["bounce"] > 0 and launched["K4"] == 0
    with monkeypatch.context() as m:
        m.setattr(integrator, "_regen_step_parts",
                  integrator._eager_step_parts)
        m.setattr(integrator, "_stages", collections.OrderedDict())
        want, want_stats = render.render(scene, cam, config)
    assert np.array_equal(img, want)
    assert stats["segments"] == want_stats["segments"]
