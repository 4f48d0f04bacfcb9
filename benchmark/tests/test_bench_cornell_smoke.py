"""The configuration ``cornell_smoke``: *The Next Week*'s Cornell box with
its two boxes made of smoke and fog (the chapter "Volumes",
``cornell_smoke()``; scene 7 of the reference app), written as data by
``cornell_smoke()`` from ``models.library.cornell_smoke``.  Held to the
library's scene tensor for tensor, pinned by digests, rendered by the port
and the float64 reference on the CPU at tiny sizes, and its ``render``
span's ``medium_scatters`` held to the eager step's medium winners.

Write the file again (after a change to the scene) with:

    python -c "import sys; sys.path.insert(0, 'benchmark/tests'); \\
        import test_bench_cornell_smoke as t; t.write()"
"""

import hashlib
import json
from pathlib import Path

import numpy as np

from benchmark import inputs, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer
from test_bench_random import dumps
from test_bench_scenes import _scene_digest, final_scene, mad, render_both

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "cornell_smoke.json"


def cornell_smoke() -> dict:
    """Scene 7 (scene_manager.cpp:141-169) as a configuration: the five
    walls and the larger, dimmer light of ``library.cornell_smoke``, in its
    order, then the two boxes of constant density 0.01 under their
    rotations, the tall one black, the short one white."""
    wall = [0.0, 0.0], [555.0, 555.0]
    rects = [("yz_rect", *wall, 555.0, "green"),
             ("yz_rect", *wall, 0.0, "red"),
             ("xz_rect", [113.0, 127.0], [443.0, 432.0], 554.0, "light"),
             ("xz_rect", *wall, 555.0, "white"),
             ("xz_rect", *wall, 0.0, "white"),
             ("xy_rect", *wall, 555.0, "white")]
    return {
        "name": "cornell_smoke",
        "source": "https://raytracing.github.io/books/RayTracingTheNextWeek"
                  ".html (the chapter Volumes, cornell_smoke(); scene 7 of "
                  "github.com/blackccpie/another_raytracer "
                  "src/scene_manager.cpp:141-169)",
        "precision": "float32", "background": [0.0, 0.0, 0.0],
        "camera": {"lookfrom": [278.0, 278.0, -800.0],
                   "lookat": [278.0, 278.0, 0.0], "vup": [0.0, 1.0, 0.0],
                   "vfov": 40.0, "aperture": 0.0, "focus_dist": 10.0,
                   "time0": 0.0, "time1": 1.0},
        "materials": [
            {"name": "red", "kind": "lambertian",
             "color": [0.65, 0.05, 0.05]},
            {"name": "white", "kind": "lambertian",
             "color": [0.73, 0.73, 0.73]},
            {"name": "green", "kind": "lambertian",
             "color": [0.12, 0.45, 0.15]},
            {"name": "light", "kind": "diffuse_light",
             "color": [7.0, 7.0, 7.0]},
        ],
        "transforms": [
            {"name": "tall_box", "rotate_y_deg": 15.0,
             "translate": [265.0, 0.0, 295.0]},
            {"name": "short_box", "rotate_y_deg": -18.0,
             "translate": [130.0, 0.0, 65.0]},
        ],
        "primitives": [
            {"kind": kind, "lo": lo, "hi": hi, "k": k, "material": mat}
            for kind, lo, hi, k, mat in rects] + [
            {"kind": "medium_box", "p0": [0.0, 0.0, 0.0],
             "p1": [165.0, 330.0, 165.0], "density": 0.01,
             "color": [0.0, 0.0, 0.0], "transform": "tall_box"},
            {"kind": "medium_box", "p0": [0.0, 0.0, 0.0],
             "p1": [165.0, 165.0, 165.0], "density": 0.01,
             "color": [1.0, 1.0, 1.0], "transform": "short_box"},
        ],
        "reduced": [],
    }


def write() -> None:
    CONFIG.write_text(dumps(cornell_smoke()))


def test_the_file_is_the_generator_s():
    assert CONFIG.read_text() == dumps(cornell_smoke())
    assert json.loads(CONFIG.read_text()) == cornell_smoke()


def test_builds_the_library_s_scene(tmp_path):
    """Every tensor of the configuration's scene (geometry, materials,
    textures, media, transforms) is ``models.library.cornell_smoke``'s,
    and so is the camera: no tree, six rects, two box media."""
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.models import scene as scene_lib

    cfg = cornell_smoke()
    ours, _ = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), 48, 36,
                           "cpu")
    theirs, params = library.cornell_smoke(device="cpu")
    assert _scene_digest(ours) == _scene_digest(theirs)
    assert not ours.has_accel and (ours.n_rects, ours.n_spheres,
                                   ours.n_media) == (6, 0, 2)
    assert ours.med_kind.tolist() == [scene_lib.MED_BOX] * 2
    for key, value in params.items():
        assert tuple(np.atleast_1d(cfg["camera"][key])) == tuple(
            np.atleast_1d(value)), key


def test_renders_like_the_reference(tmp_path):
    """The port (the eager wavefront on the CPU) against the float64
    reference at a tiny size: the image within a quarter of a level and
    the segments within max(4, 1%) (no sphere, so no float32 re-hit; they
    read 0-0.04 and 0.03%)."""
    img, segments, ref, ref_segments = render_both(
        cornell_smoke(), tmp_path, 48, 36, 4, 50,
        seed=inputs.request_seed(3_000_000_001, 1))
    assert mad(img, ref) <= 0.25
    assert abs(segments - ref_segments) <= max(4, 0.01 * ref_segments)


def _counted_render(cfg, tmp_path, monkeypatch, w, h, spp, depth, seed):
    """(render stats, the ``render`` root span's counts, the eager step's
    (medium, sphere) winners of live lanes) of one render of ``cfg``."""
    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.models import scene as scene_lib
    from another_raytracer_tpu_torch.ops import integrator, intersect
    from another_raytracer_tpu_torch.ops import render as render_lib
    from another_raytracer_tpu_torch.utils import profiling

    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), w, h,
                              "cpu")
    seen = {"medium": 0, "sphere": 0}
    real_hit, real_advance = intersect.closest_hit, integrator._advance
    alive = []

    def closest_hit(*a, **k):
        out = real_hit(*a, **k)
        t, kind, idx = out[0] if k.get("fold") else out
        live = (kind >= 0) & alive[-1]
        seen["medium"] += int((live & (kind == scene_lib.PRIM_MEDIUM)).sum())
        seen["sphere"] += int((live & (kind == scene_lib.PRIM_SPHERE)).sum())
        return out

    def advance(scene, o, d, time, throughput, live, *a, **k):
        alive.append(live)
        return real_advance(scene, o, d, time, throughput, live, *a, **k)

    monkeypatch.setattr(intersect, "closest_hit", closest_hit)
    monkeypatch.setattr(integrator, "_advance", advance)
    profiling.clear_spans()
    with profiling.recording():
        _, stats = render_lib.render(scene, cam, RenderConfig(
            width=w, height=h, samples_per_pixel=spp, max_depth=depth,
            seed=seed))
    roots = [s for s in profiling.spans()
             if s.parent < 0 and s.name == "render"]
    profiling.clear_spans()
    assert len(roots) == 1
    return stats, roots[0].attrs, seen


def test_render_span_counts_the_medium_scatters(tmp_path, monkeypatch):
    """The ``render`` span's ``medium_scatters`` is the eager step's count
    of live lanes whose winner is a medium, and no sphere count rides
    along; about a fifth of scene 7's segments."""
    stats, attrs, seen = _counted_render(cornell_smoke(), tmp_path,
                                         monkeypatch, 24, 18, 2, 50, seed=7)
    assert attrs["segments"] == stats["segments"]
    assert attrs["medium_scatters"] == seen["medium"]
    assert 0.1 < attrs["medium_scatters"] / attrs["segments"] < 0.3
    assert "sphere_hits" not in attrs and seen["sphere"] == 0


def test_sphere_hits_are_unchanged_beside_the_media(tmp_path, monkeypatch):
    """Scene 8 (spheres and two media): ``sphere_hits`` still counts the
    eager step's sphere winners, and ``medium_scatters`` its medium ones."""
    stats, attrs, seen = _counted_render(final_scene(), tmp_path,
                                         monkeypatch, 16, 12, 1, 8, seed=7)
    assert attrs["sphere_hits"] == seen["sphere"] > 0
    assert attrs["medium_scatters"] == seen["medium"] > 0
    assert attrs["sphere_hits"] + attrs["medium_scatters"] < stats["segments"]


# SceneData's tensors and the reference's image (48 x 36, spp 4, depth 8,
# request 0 of seed 3,000,000,001) and segments, as this configuration
# first built and rendered them.
PINNED = ("def2e53df934ce742c3204e4b7aba811854b3591bc8e3b734ebad570aa5e463a",
          "ff59541aa08ce0e7c333ae3616457434c7810393740ae764d32f8b6e4de39c9b",
          24528)


def test_the_configuration_is_pinned(tmp_path):
    cfg = json.loads(CONFIG.read_text())
    files = inputs.write_inputs(cfg, tmp_path)
    scene, _ = scenes.build(cfg, files, 48, 36, "cpu")
    img, segments = tracer.render(
        ref_scene.build(cfg, files, "cpu"),
        tracer.camera(cfg["camera"], 48, 36), width=48, height=36, spp=4,
        max_depth=8, seed=inputs.request_seed(3_000_000_001, 0))
    digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
    assert (_scene_digest(scene), digest, segments) == PINNED
