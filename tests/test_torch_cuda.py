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
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera, rng, vec3
from another_raytracer_tpu_torch.ops.kernels import mega_kernel
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
