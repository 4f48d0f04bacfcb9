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
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera, rng, vec3
from another_raytracer_tpu_torch.ops.kernels import mega_diff, mega_kernel
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
