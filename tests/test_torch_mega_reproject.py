"""The megakernel's sphere hits re-projected onto their spheres, on the CPU
(no JAX): the plain versions of K1 and K3 against the port's wavefront and
against the float64 reference of the benchmark, and the sphere hits they
count.

Each route takes a sphere hit's point and normal from
``intersect._onto_sphere``, the rule's one definition: the megakernel's
plain version through ``mega_kernel._onto_winner``, the wavefront through
its records.  The two routes round the rest of a segment in their own
ways, so on scene 1 (lens, glass, 871 spheres) a few paths part at an edge:
they are held to the bar of tests/test_mega.py:37-45, max(4, 1%) of the
segments.  On a small sweep scene they trace the same paths.
"""

import types

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import camera, intersect, render
from another_raytracer_tpu_torch.ops.kernels import mega_kernel
from another_raytracer_tpu_torch.ops.vec3 import V3
from another_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _sweep_scene():
    """Spheres (a checker ground, metal, glass) under a rect light: K1's
    sweep, with sphere and rect winners."""
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100, b.lambertian(
        texture=b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.xz_rect(-1, 1, -2, 0, 1.5, b.diffuse_light(color=(4, 4, 4)))
    return b.build(device="cpu"), dict(lookfrom=(0, 0.5, 1.5),
                                       lookat=(0, 0, -1), vfov=60.0)


def _render(scene, params, w, h, spp, depth, seed, route):
    """(image, the ``render`` span's counts) through the megakernel (route
    None, its default) or the wavefront (False)."""
    cam = camera.make_camera(aspect_ratio=w / h, device="cpu", **params)
    saved = mega_kernel.MEGA_FORWARD
    mega_kernel.MEGA_FORWARD = route
    profiling.clear_spans()
    try:
        with profiling.recording():
            img, _ = render.render(scene, cam, RenderConfig(
                width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                seed=seed))
        counts = [s.attrs for s in profiling.spans() if s.name == "render"]
    finally:
        mega_kernel.MEGA_FORWARD = saved
        profiling.clear_spans()
    return img, counts[0]


def _routes(scene, params, *size):
    cam = camera.make_camera(aspect_ratio=size[0] / size[1], device="cpu",
                             **params)
    assert mega_kernel.enabled(scene, cam)
    return [_render(scene, params, *size, route) for route in (None, False)]


def test_k3_traces_scene1_like_the_wavefront():
    scene, params = library.random_scene(device="cpu")
    (img_k, k3), (img_w, wave) = _routes(scene, params, 48, 36, 4, 50, 2)
    bar = max(4, 0.01 * wave["segments"])
    assert abs(k3["segments"] - wave["segments"]) <= bar
    # Every segment of scene 1 that meets something meets a sphere.
    assert 0 < k3["sphere_hits"] < k3["segments"]
    assert abs(k3["sphere_hits"] - wave["sphere_hits"]) <= bar
    assert np.abs(img_k.astype(int) - img_w.astype(int)).mean() < 1.0


def test_k1_counts_the_wavefront_s_sphere_hits():
    scene, params = _sweep_scene()
    (img_k, k1), (img_w, wave) = _routes(scene, params, 32, 24, 4, 50, 3)
    assert mega_kernel.supports(scene, camera.make_camera(
        aspect_ratio=4 / 3, device="cpu", **params))
    assert k1 == wave and 0 < k1["sphere_hits"] < k1["segments"]
    np.testing.assert_array_equal(img_k, img_w)


@pytest.mark.parametrize("name", ["random_scene", "sweep"])
def test_the_count_is_the_record_s_sphere_winners(name):
    """The forward plain version's ``sphere_hits`` against the record
    instance's rows on the same lanes (the same paths): a row is nonzero on
    each live loop iteration, and every iteration that neither misses (event
    3) nor meets the rect light (event 2; the spheres emit nothing) has a
    sphere winner."""
    scene, params = (_sweep_scene() if name == "sweep"
                     else library.random_scene(device="cpu"))
    w, h, spp, depth = 24, 18, 2, 8
    cam = camera.make_camera(aspect_ratio=w / h, device="cpu", **params)
    pix, samp = torch.arange(w * h), torch.zeros(w * h, dtype=torch.int64)
    kw = dict(width=w, height=h, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=depth, t_min=1e-3)
    counts = {}
    _, segs = mega_kernel.trace_regenerative_mega(scene, cam, pix, samp, 5,
                                                  counts=counts, **kw)
    _, rec_segs, codes, _ = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp, 5, record_iters=spp * depth, **kw)
    ev = codes & 3
    want = int(((codes != 0) & (ev != 3) & (ev != 2)).sum())
    assert int(segs) == int(rec_segs)
    assert int(counts["sphere_hits"]) == want > 0
    assert bool((ev == 2).any()) == (name == "sweep")


def test_a_scene_without_spheres_counts_none():
    scene, params = library.cornell_box(device="cpu")
    _, k1 = _render(scene, params, 24, 24, 1, 8, 1, None)
    assert k1["segments"] > 0 and "sphere_hits" not in k1


def test_the_winner_is_the_wavefront_s_record():
    """``_onto_winner`` gives the folded wavefront record's point and
    normal (``intersect._sphere_record_aux``) bit for bit, on the sphere
    to rounding, where ``o + t d`` lies off it."""
    gen = torch.Generator().manual_seed(4)
    n = 4096
    center = V3(*(torch.rand(n, generator=gen) * 800 - 400 for _ in range(3)))
    r = torch.rand(n, generator=gen) * 99 + 1
    d = V3(*(torch.randn(n, generator=gen) for _ in range(3)))
    o = center - d * (r * 3.0)
    # The nearer root of |o + t d - c| = r, in float32.
    a = d.x * d.x + d.y * d.y + d.z * d.z
    oc = o - center
    half_b = oc.x * d.x + oc.y * d.y + oc.z * d.z
    c = oc.x * oc.x + oc.y * oc.y + oc.z * oc.z - r * r
    t = (-half_b - torch.sqrt(half_b * half_b - a * c)) / a
    n_k, p_k = mega_kernel._onto_winner(o, d, t, center, r, 1.0 / r)
    scene = types.SimpleNamespace(mat_kind=torch.zeros(1))
    _, p_w, n_w, *_ = intersect._sphere_record_aux(
        scene, o, d, t, (center, r, torch.zeros(n), torch.zeros(n)))
    for got, want in zip((*n_k, *p_k), (*n_w, *p_w)):
        assert torch.equal(got, want)

    def miss(p):  # |p - c| - r in float64
        off = (p - center).map(torch.Tensor.double)
        return (off.x ** 2 + off.y ** 2 + off.z ** 2).sqrt() - r.double()

    # Off by the rounding of coordinates up to ~700 (2.4e-5 here), where
    # o + t d misses by up to ~1e-3.
    assert float(miss(p_k).abs().max()) < 0.1 * float(
        miss(o + d * t).abs().max())


@pytest.mark.parametrize("size", [(48, 36, 4, 8)])
def test_scene1_renders_like_the_float64_reference(tmp_path, size):
    """K3's plain version on the benchmark's configuration of scene 1
    against the float64 reference (``benchmark/reference``), as the
    benchmark's comparison holds the card's render."""
    import json
    from pathlib import Path

    from benchmark import compare, inputs, scenes
    from benchmark.reference import scene as ref_scene
    from benchmark.reference import tracer

    cfg = json.loads((Path(__file__).resolve().parents[1] / "benchmark"
                      / "configs" / "random.json").read_text())
    w, h, spp, depth = size
    files = inputs.write_inputs(cfg, tmp_path)
    scene, cam = scenes.build(cfg, files, w, h, "cpu")
    assert mega_kernel.supports_accel(scene, cam)
    seed = inputs.request_seed(3_000_000_001, 1)
    img, stats = render.render(scene, cam, RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, seed=seed))
    ref, segments = tracer.render(
        ref_scene.build(cfg, files, "cpu"), tracer.camera(cfg["camera"], w, h),
        width=w, height=h, spp=spp, max_depth=depth, seed=seed)
    numbers = compare.image(img, ref)
    assert numbers["image_mad"] <= 1.0
    assert compare.rel_gap(stats["segments"], segments) <= 2e-2


@pytest.mark.parametrize("bad", [dict(record_iters=8), dict(tally=True),
                                 dict(dtype=torch.float32)])
def test_only_a_forward_launch_takes_the_counter(bad):
    """The record and counting instances count no sphere hits, and the
    counter is a 0-d int64 tensor: refused before any launch."""
    scene, params = library.random_scene(device="cpu")
    cam = camera.make_camera(aspect_ratio=4 / 3, device="cpu", **params)
    bad = dict(bad)
    hits = torch.zeros((), dtype=bad.pop("dtype", torch.int64))
    with pytest.raises(ValueError, match="sphere_hits"):
        mega_kernel.prepare_launch(
            scene, cam, torch.arange(12), torch.zeros(12, dtype=torch.int64),
            3, width=4, height=3, sample_stride=1, sample_end=1, spp_cap=1,
            max_depth=8, t_min=1e-3, sphere_hits=hits, **bad)
