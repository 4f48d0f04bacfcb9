"""The wavefront's count of medium scatters (``medium_scatters``: the live
lanes whose winner is a medium, each a scatter in it), on the CPU.

* The ``render`` span's ``medium_scatters`` equals the live medium winners
  counted from each bounce's alive mask and winner kinds, on scenes 7 and 8
  and a medium box under a rotation, and ``sphere_hits`` beside it still
  equals the live sphere winners.
* The graph path (the capture injected as ``test_torch_graphs.py`` does)
  counts what the eager path counts, over renders that capture and replay
  across compaction stages.
* Counting changes no bit of the radiance or the segments, and a scene
  without media gets no counter and runs no op for it.

The card's side (the bounce kernel's warp-aggregated count against the
eager step, at the benchmark cell's width) is in
``tests/test_torch_bounce_cuda.py``.
"""

import collections

import pytest
import torch

from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.ops import (camera, integrator, intersect,
                                            render)
from another_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

T_MIN = 1e-3


def _fog_box(device="cpu"):
    """A rotated medium box in front of a lit wall: every segment tests the
    box's slabs in its own frame."""
    b = SceneBuilder(background=(0.1, 0.1, 0.1), seed=3)
    xf = b.transform(rotate_y_deg=-30.0, translate=(0.2, -0.5, -2.5))
    b.constant_medium_box((-0.6, 0.0, -0.6), (0.6, 1.2, 0.6), 0.9,
                          color=(0.8, 0.8, 0.8), xform=xf)
    b.xy_rect(-3, 3, -3, 3, -4, b.lambertian(color=(0.7, 0.7, 0.7)))
    b.xz_rect(-1, 1, -3, -2, 1.5, b.diffuse_light(color=(4, 4, 4)))
    return b.build(device=device), dict(lookfrom=(0, 0.3, 1.0),
                                        lookat=(0, 0, -2), vfov=60.0)


SCENES = {"cornell_smoke": library.cornell_smoke,
          "final_scene": library.final_scene, "fog_box": _fog_box,
          "two_perlin_spheres": library.two_perlin_spheres}


def _scene(name, w=16, h=12):
    scene, params = SCENES[name](device="cpu")
    return scene, camera.make_camera(aspect_ratio=w / h, device="cpu",
                                     **params)


def _counted_render(scene, cam, **kw):
    """A render inside ``profiling.recording()``: (image, stats, the root
    span's counts, {kind: live winners of that kind} counted on the CPU
    from each bounce's alive mask and winner kinds)."""
    kinds, alives = [], []
    real_hit, real_advance = intersect.closest_hit, integrator._advance

    def closest_hit(*a, **k):
        out = real_hit(*a, **k)
        kinds.append((out[0] if k.get("fold") else out)[1])
        return out

    def advance(scene_, o, d, time, throughput, alive, *a, **k):
        alives.append(alive.clone())
        return real_advance(scene_, o, d, time, throughput, alive, *a, **k)

    cfg = RenderConfig(**{"width": 16, "height": 12, "samples_per_pixel": 2,
                          "max_depth": 8, "seed": 7, **kw})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(intersect, "closest_hit", closest_hit)
        m.setattr(integrator, "_advance", advance)
        profiling.clear_spans()
        with profiling.recording():
            img, stats = render.render(scene, cam, cfg)
        spans = profiling.spans()
        profiling.clear_spans()
    roots = [s for s in spans if s.name == "render" and s.parent < 0]
    assert len(roots) == 1 and len(kinds) == len(alives)
    cpu = {kind: sum(int(((k == kind) & a).sum())
                     for k, a in zip(kinds, alives))
           for kind in (scene_lib.PRIM_MEDIUM, scene_lib.PRIM_SPHERE)}
    return img, stats, roots[0].attrs, cpu


@pytest.mark.parametrize("name", ["cornell_smoke", "final_scene", "fog_box"])
def test_render_span_counts_the_medium_scatters(name):
    scene, cam = _scene(name)
    _, stats, attrs, cpu = _counted_render(scene, cam)
    assert attrs["segments"] == stats["segments"]
    assert attrs["medium_scatters"] == cpu[scene_lib.PRIM_MEDIUM] > 0
    assert attrs["medium_scatters"] < attrs["segments"]
    if scene.n_spheres:
        assert attrs["sphere_hits"] == cpu[scene_lib.PRIM_SPHERE] > 0
    else:
        assert "sphere_hits" not in attrs


@pytest.mark.parametrize("name", ["cornell_smoke", "final_scene"])
def test_graph_path_counts_the_same_medium_scatters(name, monkeypatch):
    """Renders that capture and replay, over stages narrowed so that the
    compactions run, count the eager path's medium scatters."""
    def fake(device):
        return lambda fn: fn

    scene, cam = _scene(name, 24, 24)
    kw = dict(width=24, height=24, samples_per_pixel=2, max_depth=8)
    eager = [_counted_render(scene, cam, seed=s, **kw) for s in (3, 4)]
    monkeypatch.setitem(integrator.GRAPHS, "cpu", fake)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    for (img, stats, attrs, cpu), seed in zip(eager * 2, (3, 4, 3, 4)):
        g_img, g_stats, g_attrs, _ = _counted_render(scene, cam, seed=seed,
                                                     **kw)
        assert (g_img == img).all() and g_stats == stats
        assert g_attrs == attrs
        assert attrs["medium_scatters"] == cpu[scene_lib.PRIM_MEDIUM]
    stages = integrator._stages.values()
    assert "replay" in {st.mode for st in stages}
    assert all("medium_scatters" in st.counters for st in stages)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_counting_changes_no_bit(name, monkeypatch):
    """``trace_regenerative`` counting and with nothing to count
    (``COUNTED`` emptied): the same radiance and segments, bit for bit; the
    counters exist for the kinds the scene has, and ``_advance`` gets none
    for a kind it lacks."""
    scene, cam = _scene(name)
    given = []
    real = integrator._advance

    def advance(*a, **k):
        given.append((k.get("sphere_hits"), k.get("medium_scatters")))
        return real(*a, **k)

    monkeypatch.setattr(integrator, "_advance", advance)
    pix = torch.arange(16 * 12).repeat(2)
    samp0 = torch.arange(2).repeat_interleave(16 * 12)
    kw = dict(width=16, height=12, sample_stride=2, sample_end=4, spp_cap=4,
              max_depth=8, t_min=T_MIN)
    counts = {}
    acc, segs = integrator.trace_regenerative(scene, cam, pix, samp0, 5,
                                              counts=counts, **kw)
    has = {"sphere_hits": bool(scene.n_spheres),
           "medium_scatters": bool(scene.n_media)}
    assert set(counts) == {k for k, v in has.items() if v}
    assert given and all((hits is not None, scatters is not None)
                         == (has["sphere_hits"], has["medium_scatters"])
                         for hits, scatters in given)
    monkeypatch.setattr(integrator, "COUNTED", ())
    given.clear()
    uncounted = {}
    want, want_segs = integrator.trace_regenerative(
        scene, cam, pix, samp0, 5, counts=uncounted, **kw)
    assert all(torch.equal(a, b) for a, b in zip(acc, want))
    assert int(segs) == int(want_segs)
    assert uncounted == {} and set(given) == {(None, None)}
