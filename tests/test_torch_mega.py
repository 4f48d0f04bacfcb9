"""Port vs JAX: the forward megakernel's row pack and its plain PyTorch
version, held against the Pallas kernel in interpret mode with the bar of
tests/test_mega.py:37-45 (segment drift <= max(4, 1%), <= 2% of lane values
off by more than 2e-2, median difference < 1e-5: ulp-level differences in
sin/cos/sqrt between XLA and PyTorch can flip a path at an edge), with the
port's re-projection of sphere hits taken out (``megakernel_like_jax``,
tests/jax_sphere_record.py: the Pallas kernel takes ``o + t d``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from another_raytracer_tpu.models import library as jlib
from another_raytracer_tpu.models.scene import SceneBuilder as JBuilder
from another_raytracer_tpu.ops import camera as jcam
from another_raytracer_tpu.ops import vec3 as jvec3
from another_raytracer_tpu.ops.pallas import mega_kernel as jmk
from another_raytracer_tpu_torch.models import library as tlib
from another_raytracer_tpu_torch.models import scene as tscene
from another_raytracer_tpu_torch.ops import camera as tcam
from another_raytracer_tpu_torch.ops import render as trender
from another_raytracer_tpu_torch.ops import vec3 as tvec3
from another_raytracer_tpu_torch.ops.kernels import mega_kernel as tmk
from jax_sphere_record import megakernel_like_jax  # noqa: F401

torch.set_num_threads(1)

W, H, SPP, DEPTH = 24, 18, 4, 5
KW = dict(width=W, height=H, sample_stride=1, sample_end=SPP, spp_cap=SPP,
          max_depth=DEPTH, t_min=1e-3)


def _metal_scene():
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
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    return b.build(), cam


SCENES = {
    "cornell_box": jlib.cornell_box,
    "two_spheres": jlib.two_spheres,
    "lens_motion_metal_dielectric_checker": _metal_scene,
}


def _both(name):
    """(JAX scene, JAX camera), (port scene, port camera) for one scene."""
    ref, params = SCENES[name]()
    ref_cam = jcam.make_camera(aspect_ratio=W / H, **params)
    port = tscene.scene_from_reference(ref, device="cpu")
    return (ref, ref_cam), (port, tcam.camera_from_reference(ref_cam,
                                                             device="cpu"))


def _lanes():
    return torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64)


def _radiance_batch(scene, cam, pixel_ids, **kw):
    return trender.radiance_batch(scene, cam, pixel_ids, 3, **kw)


@pytest.mark.parametrize("name", list(SCENES))
def test_pack_rows_matches_reference(name):
    (ref, ref_cam), (port, cam) = _both(name)
    np.testing.assert_allclose(tmk.pack_rows(port).numpy(),
                               np.asarray(jmk.pack_rows(ref)), rtol=1e-6,
                               atol=1e-6)
    assert tmk.supports(port, cam) and jmk.supports(ref, ref_cam)


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_kernel_matches_reference(name, megakernel_like_jax):
    (ref, ref_cam), (port, cam) = _both(name)
    want, want_segs = jmk.trace_regenerative_mega(
        ref, ref_cam, jnp.arange(W * H, dtype=jnp.uint32),
        jnp.zeros(W * H, jnp.uint32), jnp.uint32(3), interpret=True, **KW)
    got, got_segs = tmk.trace_regenerative_mega(port, cam, *_lanes(), 3, **KW)
    want, got = jvec3.to_numpy(want), tvec3.to_numpy(got)
    assert abs(int(got_segs) - int(want_segs)) <= max(4, 0.01 * int(want_segs))
    diff = np.abs(got - want)
    assert (diff > 2e-2).mean() <= 0.02, f"max {diff.max():.2e}"
    assert np.median(diff) < 1e-5


def test_pad_and_masked_lanes_contribute_nothing():
    port, params = tlib.cornell_box(device="cpu")
    cam = tcam.make_camera(aspect_ratio=W / H, device="cpu", **params)
    pix, samp = _lanes()
    base, base_segs = tmk.trace_regenerative_mega(port, cam, pix, samp, 3, **KW)
    # Born-dead pad lanes (sample 0xFFFFFFFF) appended to the batch.
    pad_pix = torch.cat([pix, torch.arange(100)])
    pad_samp = torch.cat([samp, torch.full((100,), 0xFFFFFFFF)])
    padded, padded_segs = tmk.trace_regenerative_mega(port, cam, pad_pix,
                                                      pad_samp, 3, **KW)
    assert int(padded_segs) == int(base_segs)
    for a, b in zip(base, padded):
        assert torch.equal(a, b[:W * H]) and torch.all(b[W * H:] == 0)
    # radiance_batch's lane_mask: masked pixels add no radiance, no segments.
    mask = torch.arange(W * H) % 3 != 0
    kw = dict(width=W, height=H, sample_start=0, n_samples=SPP, spp_cap=SPP,
              samples_per_pass=1, max_depth=DEPTH, t_min=1e-3)
    full, _ = _radiance_batch(port, cam, pix, **kw)
    masked, masked_segs = _radiance_batch(port, cam, pix, lane_mask=mask, **kw)
    only, only_segs = _radiance_batch(port, cam, pix[mask], **kw)
    assert int(masked_segs) == int(only_segs)
    for a, b, c in zip(full, masked, only):
        assert torch.all(b[~mask] == 0)
        assert torch.equal(b[mask], c) and torch.equal(b[mask], a[mask])


def test_supports_matches_reference():
    cases = [jlib.cornell_box(), jlib.two_spheres(), jlib.two_perlin_spheres(),
             jlib.simple_light(), jlib.cornell_smoke(), jlib.final_scene(),
             _metal_scene()]
    verdicts = []
    for ref, params in cases:
        ref_cam = jcam.make_camera(aspect_ratio=1.0, **params)
        port = tscene.scene_from_reference(ref, device="cpu")
        cam = tcam.camera_from_reference(ref_cam, device="cpu")
        verdicts.append(tmk.supports(port, cam))
        assert verdicts[-1] == jmk.supports(ref, ref_cam)
    assert verdicts == [True, True, False, False, False, False, True]
    with pytest.raises(ValueError, match="not supported"):
        tmk.trace_regenerative_mega(
            tscene.scene_from_reference(cases[2][0], device="cpu"), cam,
            *_lanes(), 0, **KW)



@pytest.mark.parametrize("name", list(SCENES))
def test_pack_sweep_tables_holds_the_rows_geometry(name):
    # The sweep's 16-byte tables hold exactly pack_rows' geometry values:
    # spheres (c0, r | c1 - c0, t0 | 1/dt, 0, 0, 0), rects (n, n.q0 | q0,
    # |eu|^2 | eu, |ev|^2 | ev, 0).  The plain version sweeps these tables
    # (test_plain_kernel_matches_reference holds it against JAX).
    _, (port, _) = _both(name)
    rows = tmk.pack_rows(port).reshape(-1, tmk.ROW_W)
    tab = tmk.pack_sweep_tables(port)
    ns, nr = port.n_spheres, port.n_rects
    assert tab.shape == (3 * ns + 4 * nr, 4) and tab.is_contiguous()
    sph, rect = rows[:ns], rows[ns:]
    s = tab[:3 * ns].reshape(ns, 3, 4)
    q = tab[3 * ns:].reshape(nr, 4, 4)
    for got, cols in ((s[:, 0], [1, 2, 3, 9]), (s[:, 1], [4, 5, 6, 7]),
                      (s[:, 2, :1], [8])):
        assert torch.equal(got, sph[:, cols])
    for got, cols in ((q[:, 0], [10, 11, 12, 13]), (q[:, 1], [1, 2, 3, 14]),
                      (q[:, 2], [4, 5, 6, 15]), (q[:, 3, :3], [7, 8, 9])):
        assert torch.equal(got, rect[:, cols])
    assert not s[:, 2, 1:].any() and not q[:, 3, 3].any()
    if name == "lens_motion_metal_dielectric_checker":
        # The moving sphere: a centre offset and 1/dt.
        assert s[:, 1, :3].any() and s[:, 2, 0].any()


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_sweep_counts_its_row_tests(name):
    # With work=True the plain version returns the sweep's sphere and rect
    # row tests (what the counting instance tallies on the card): every row
    # for each loop iteration of each alive lane.  A record row is nonzero
    # exactly on those iterations.
    _, (port, cam) = _both(name)
    kw = dict(KW, record_iters=SPP * DEPTH)
    _, _, codes, _, (spheres, rects) = tmk.trace_regenerative_mega_reference(
        port, cam, *_lanes(), 3, work=True, **kw)
    steps = int((codes != 0).sum())
    assert steps > W * H
    assert (spheres, rects) == (port.n_spheres * steps, port.n_rects * steps)
