"""The bounce kernel (``csrc/bounce_kernel.cu``) against the wavefront's
eager step on the card, bit for bit.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX (the GPU machine has none); run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bounce_cuda.py -q

Each step compares the kernel step (``integrator._kernel_step_parts``: K5
over the trees, then the kernel) with the eager step
(``integrator._eager_step_parts``: the same K5, K4 and draws kernels and
PyTorch's ops) on one carry: the whole next carry, the re-arm mask and
flag, the segments and the sphere winners.  The scenes hold every
primitive, material, texture and medium kind between them; the widths take
each of K5's record folds (planar, sphere) and none.
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
    the kernel step against the eager step on each carry the eager loop
    reaches, in new tensors and in place.  Returns the folds and how many
    lanes were alive, hit a sphere and re-armed, summed over the steps."""
    n_pix = width // spp
    pix = (torch.arange(width, device=dev) % n_pix)
    samp0 = torch.arange(width, device=dev) // n_pix
    args = (scene, cam, pix, seed, W, H, spp, 3 * spp, max_depth, T_MIN)
    k_hits = torch.zeros((), dtype=torch.int64, device=dev)
    e_hits = torch.zeros((), dtype=torch.int64, device=dev)
    cam_rays, k_step, k_rearm = integrator._kernel_step_parts(*args, k_hits)
    _, e_step, e_rearm = integrator._eager_step_parts(*args, e_hits)
    assert k_step.kind == "kernel" and e_step.kind == "eager"
    state = integrator._regen_initial_state(cam_rays, samp0, 3 * spp)
    seen = collections.Counter()
    for it in range(iters):
        before = kernels.COUNTS["bounce"]
        got, g_regen, g_any = k_step(state)
        assert kernels.COUNTS["bounce"] == before + 1
        want, w_regen, w_any = e_step(state)
        for k, (a, b) in enumerate(zip(_flat(got), _flat(want))):
            assert _same(a, b), f"step {it}: carry tensor {k}: {_diff(a, b)}"
        assert _same(g_regen, w_regen), f"step {it}: regen: " + _diff(
            g_regen, w_regen)
        assert bool(g_any) == bool(w_any)
        assert int(k_hits) == int(e_hits)
        # In place, into a copy of the carry: the same bits.
        bufs = [t.clone() for t in _flat(state)]
        carry = integrator._unflatten(bufs)
        new, _, _ = k_step(carry, into=carry)
        assert all(a is b for a, b in zip(_flat(new), bufs))
        for k, (a, b) in enumerate(zip(bufs, _flat(want))):
            assert _same(a, b), f"step {it}: in place, tensor {k} differs"
        k_hits.copy_(e_hits)
        seen["alive"] += int(state[6].sum())
        seen["regen"] += int(w_regen.sum())
        if bool(w_any):
            state = e_rearm(want, w_regen)
            k_rearm(got, g_regen)  # clears the kernel's flag
            assert int(g_any) == 0
        else:
            state = want
    seen["sphere_hits"] = int(e_hits)
    return seen


@pytest.mark.parametrize("fold", ["record", "none"])
@pytest.mark.parametrize("name", BENCH + tuple(LIBRARY))
def test_kernel_step_equals_eager_step(name, fold, dev, tmp_path,
                                       monkeypatch):
    """The kernel step's carry, re-arm mask and flag, segments and sphere
    winners equal the eager step's, step by step, at a width where K5 folds
    its winner record ("record": 8,192 lanes with the gates lowered to 4,096)
    and one where it does not (2,048 lanes)."""
    monkeypatch.setattr(intersect, "FOLD_RECORD_MIN_B", 4096)
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", 4096)
    scene, cam = _scene(name, tmp_path, dev)
    width = 8192 if fold == "record" else 2048
    seen = _check_steps(scene, cam, width, width // (W * H), dev)
    assert seen["alive"] > 0
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
