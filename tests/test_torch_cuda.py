"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX (the GPU machine has none); run it there without the JAX
test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch import cli
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import bvh as bvh_ops
from another_raytracer_tpu_torch.ops import camera, rng, shade, vec3
from another_raytracer_tpu_torch.ops.kernels import (bvh_kernel, mega_diff,
                                                     mega_kernel, perlin_kernel)
from another_raytracer_tpu_torch.utils import imageio

torch.set_num_threads(1)

W, H = 96, 72

pytestmark = pytest.mark.cuda


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
    v0, v1 = rng.uniform2(7, pix, samp, 3, 2)
    assert torch.equal(u0, v0) and torch.equal(u1, v1)


@pytest.mark.parametrize("name", list(SCENES))
def test_kernel_matches_plain(name, dev):
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=8, spp_cap=8,
              max_depth=50, t_min=1e-3)
    before = mega_kernel.trace_regenerative_mega.launches
    got, got_segs = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp,
                                                        3, **kw)
    assert mega_kernel.trace_regenerative_mega.launches == before + 1
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


def test_cli_renders_through_the_kernel(dev, tmp_path):
    out = tmp_path / "cornell.png"
    before = mega_kernel.trace_regenerative_mega.launches
    assert cli.main(["--scene", "6", "--width", str(W), "--height", str(H),
                     "--spp", "16", "--max-depth", "50", "--mode", "single",
                     "--device", "cuda", "--out", str(out)]) == 0
    assert mega_kernel.trace_regenerative_mega.launches == before + 1
    img = imageio.load_png(out)
    assert img.shape == (H, W, 3) and img.mean() > 5.0


def _record(name, dev, spp=4, depth=8, seed=3):
    scene, params = SCENES[name](device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    pix = torch.arange(W * H, device=dev)
    samp = torch.zeros(W * H, dtype=torch.int64, device=dev)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=spp, spp_cap=spp,
              max_depth=depth, t_min=1e-3, record_iters=spp * depth)
    before = mega_kernel.trace_regenerative_mega.record_launches
    got = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, seed, **kw)
    assert mega_kernel.trace_regenerative_mega.record_launches == before + 1
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


@pytest.mark.parametrize("name", list(SCENES))
def test_replay_kernel_matches_plain(name, dev):
    scene, got, _ = _record(name, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ghat = vec3.V3(*(torch.rand(W * H, generator=gen, device=dev) + 0.2
                     for _ in range(3)))
    args = (got[2], got[3], ghat, scene.tex_ca, scene.tex_cb,
            scene.background, mega_diff._flags(scene))
    before = mega_diff.replay_backward.launches
    kern = mega_diff.replay_backward(*args)
    assert mega_diff.replay_backward.launches == before + 1
    plain = mega_diff.replay_backward_reference(*args)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
    assert float(kern[0].abs().max()) > 0


def test_fused_grads_match_lockstep_on_card(dev):
    scene, params = library.cornell_box(device=dev)
    cam = camera.make_camera(aspect_ratio=W / H, device=dev, **params)
    kw = dict(width=W, height=H, spp=4, samples_per_pass=1, max_depth=6,
              t_min=1e-3)
    leaves, _ = diff.split_params(scene)
    target = torch.zeros((W * H, 3), device=dev)
    k2 = mega_kernel.trace_regenerative_mega.record_launches
    rp = mega_diff.replay_backward.launches
    loss_f, g_f = diff.render_value_and_grad(leaves, scene, cam, target, 4, **kw)
    assert mega_kernel.trace_regenerative_mega.record_launches == k2 + 1
    assert mega_diff.replay_backward.launches == rp + 1
    saved = mega_diff.FUSED_DIFF
    mega_diff.FUSED_DIFF = False
    try:
        loss_l, g_l = diff.render_value_and_grad(leaves, scene, cam, target, 4,
                                                 **kw)
    finally:
        mega_diff.FUSED_DIFF = saved
    assert mega_kernel.trace_regenerative_mega.record_launches == k2 + 1
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


@pytest.mark.parametrize("prim,fold,full,pre", BVH_VARIANTS)
def test_bvh_kernel_matches_plain(prim, fold, full, pre, dev):
    """Built without FMA contraction, K5 equals its plain version bit for
    bit: hit mask, code, t and every fold output."""
    nodes, rows, o, d, time = _bvh_inputs(prim)
    n = o.shape[1]
    args = (torch.from_numpy(nodes).to(dev), torch.from_numpy(rows).to(dev),
            vec3.V3(*(torch.from_numpy(c).to(dev) for c in o)),
            vec3.V3(*(torch.from_numpy(c).to(dev) for c in d)),
            torch.full((n,), 3e37, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev))
    kw = dict(leaf_size=16, prim=prim, time=torch.from_numpy(time).to(dev),
              fold_record=fold, fold_full=full, precomp=pre)
    before = bvh_kernel.bvh_closest_hit.launches
    got = bvh_kernel.bvh_closest_hit(*args, **kw)
    assert bvh_kernel.bvh_closest_hit.launches == before + 1
    want = bvh_ops.traverse_packed(*args[:4], kw.pop("time"), 1e-3, *args[4:],
                                   **kw)
    flat = lambda out: [x for v in out for x in (v if isinstance(v, vec3.V3) else (v,))]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)
    assert 0 < int(got[2].sum()) < n


def test_perlin_kernel_matches_plain(dev):
    b = SceneBuilder(seed=3)
    for scale in (4.0, 0.1):
        b.sphere((0, 0, 0), 1.0, b.lambertian(texture=b.noise_texture(scale)))
    scene = b.build(device=dev)
    g = np.random.default_rng(1)
    p = g.uniform(-60, 60, (3, 1 << 16)).astype(np.float32)
    pv = vec3.V3(*(torch.from_numpy(c).to(dev) for c in p))
    ids = torch.from_numpy(g.integers(0, 2, 1 << 16)).to(dev)
    before = perlin_kernel.perlin_noise.launches
    got = perlin_kernel.perlin_noise(scene, ids, pv)
    assert perlin_kernel.perlin_noise.launches == before + 1
    assert torch.equal(got, shade.perlin_noise(scene, ids, pv))


def test_cli_renders_bvh_and_noise_scenes_through_the_kernels(dev, tmp_path):
    for scene_id, counter in (("1", bvh_kernel.bvh_closest_hit),
                              ("3", perlin_kernel.perlin_noise),
                              ("5", perlin_kernel.perlin_noise)):
        out = tmp_path / f"scene{scene_id}.png"
        before = counter.launches
        assert cli.main(["--scene", scene_id, "--width", str(W), "--height",
                         str(H), "--spp", "4", "--max-depth", "20", "--mode",
                         "single", "--device", "cuda", "--out", str(out)]) == 0
        assert counter.launches > before
        img = imageio.load_png(out)
        assert img.shape == (H, W, 3) and img.mean() > 5.0
