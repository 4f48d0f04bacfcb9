"""The configuration language beyond the Cornell box and the capsule: every
texture, material, primitive and camera key, read by the program's builder
(``benchmark/scenes.py``) and by the float64 reference
(``benchmark/reference``), rendered by both on the CPU at tiny sizes; The
Next Week's final scene written as a configuration; the Perlin tables of
``scene_seed``; and digests that pin what the two accepted configurations
build and render."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, scenes
from benchmark.reference import perlin
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def every_key() -> dict:
    """A scene that uses every key of the language: checker, Perlin and
    image spheres, metal, dielectric, a moving sphere, an instanced group,
    a medium inside a glass sphere, a box medium under a transform, a light
    over a texture and a defocus camera."""
    group = np.random.default_rng(5).uniform(0.0, 1.2, (12, 3))
    return {
        "name": "every_key", "precision": "float32",
        "background": [0.7, 0.8, 1.0], "scene_seed": 7,
        "camera": {"lookfrom": [8.0, 2.5, 6.0], "lookat": [0.0, 0.8, 0.0],
                   "vup": [0.0, 1.0, 0.0], "vfov": 40.0, "aperture": 0.2,
                   "focus_dist": 10.0, "time0": 0.0, "time1": 1.0},
        "textures": [
            {"name": "ground", "kind": "checker", "even": [0.2, 0.3, 0.1],
             "odd": [0.9, 0.9, 0.9]},
            {"name": "marble", "kind": "noise", "scale": 4.0},
            {"name": "earth", "kind": "image", "generator": "earthmap",
             "width": 1024, "height": 512},
            {"name": "lamp", "kind": "solid", "color": [6.0, 6.0, 5.0]},
        ],
        "materials": [
            {"name": "ground", "kind": "lambertian", "texture": "ground"},
            {"name": "marble", "kind": "lambertian", "texture": "marble"},
            {"name": "globe", "kind": "lambertian", "texture": "earth"},
            {"name": "chrome", "kind": "metal", "color": [0.8, 0.8, 0.9],
             "fuzz": 0.3},
            {"name": "glass", "kind": "dielectric", "ir": 1.5},
            {"name": "rust", "kind": "lambertian", "color": [0.7, 0.3, 0.1]},
            {"name": "white", "kind": "lambertian",
             "color": [0.73, 0.73, 0.73]},
            {"name": "lamp", "kind": "diffuse_light", "texture": "lamp"},
        ],
        "transforms": [
            {"name": "group", "rotate_y_deg": 30.0,
             "translate": [-3.5, 0.0, 1.5]},
            {"name": "fog", "rotate_y_deg": 20.0,
             "translate": [0.5, 0.0, -3.2]},
        ],
        "primitives": [
            {"kind": "sphere", "center": [0.0, -1000.0, 0.0],
             "radius": 1000.0, "material": "ground"},
            {"kind": "sphere", "center": [0.0, 1.0, 0.0], "radius": 1.0,
             "material": "glass"},
            {"kind": "medium_sphere", "center": [0.0, 1.0, 0.0],
             "radius": 1.0, "density": 0.8, "color": [0.2, 0.4, 0.9]},
            {"kind": "sphere", "center": [-2.5, 1.0, -1.0], "radius": 1.0,
             "material": "globe"},
            {"kind": "sphere", "center": [2.2, 0.8, -1.5], "radius": 0.8,
             "material": "chrome"},
            {"kind": "sphere", "center": [-1.0, 0.5, 2.2], "radius": 0.5,
             "material": "marble"},
            {"kind": "moving_sphere", "center0": [1.6, 0.35, 1.8],
             "center1": [1.6, 0.65, 1.8], "time0": 0.0, "time1": 1.0,
             "radius": 0.35, "material": "rust"},
            {"kind": "sphere", "centers": group.tolist(), "radius": 0.15,
             "material": "white", "transform": "group"},
            {"kind": "medium_box", "p0": [0.0, 0.0, 0.0],
             "p1": [1.0, 1.5, 1.0], "density": 2.0,
             "color": [0.9, 0.9, 0.9], "transform": "fog"},
            {"kind": "xz_rect", "lo": [-1.0, -1.0], "hi": [1.0, 1.0],
             "k": 4.0, "material": "lamp"},
        ],
    }


def render_both(cfg, tmp_path, w, h, spp, depth, seed):
    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import render as render_lib

    files = inputs.write_inputs(cfg, tmp_path)
    scene, cam = scenes.build(cfg, files, w, h, "cpu")
    img, stats = render_lib.render(scene, cam, RenderConfig(
        width=w, height=h, samples_per_pixel=spp, max_depth=depth, seed=seed))
    sc = ref_scene.build(cfg, files, "cpu")
    ref, segments = tracer.render(sc, tracer.camera(cfg["camera"], w, h),
                                  width=w, height=h, spp=spp,
                                  max_depth=depth, seed=seed)
    return img, stats["segments"], ref, segments


def final_scene() -> dict:
    """The Next Week's final scene (scene 8 of the reference app,
    scene_manager.cpp:171-234) as a configuration.  The 400 ground heights
    and the 1,000 instanced centres are drawn from ``default_rng(1234)`` in
    ``models.library.final_scene``'s order (the heights, then the draws of
    its noise texture's tables, then the centres), so they are the
    library's; the noise tables come from ``scene_seed``."""
    gen = np.random.default_rng(1234)
    heights = [gen.uniform(1, 101) for _ in range(400)]
    gen.uniform(-1.0, 1.0, size=(256, 3))  # the library's noise tables
    for _ in range(3):
        gen.permutation(256)
    centres = [gen.uniform(0, 165, 3).tolist() for _ in range(1000)]
    boxes = [{"kind": "box", "p0": [-1000.0 + i * 100.0, 0.0,
                                    -1000.0 + j * 100.0],
              "p1": [-900.0 + i * 100.0, heights[20 * i + j],
                     -900.0 + j * 100.0], "material": "ground"}
             for i in range(20) for j in range(20)]
    return {
        "name": "final_scene",
        "source": "https://raytracing.github.io/books/RayTracingTheNextWeek"
                  ".html (the final scene; scene 8 of github.com/blackccpie/"
                  "another_raytracer src/scene_manager.cpp:171-234)",
        "precision": "float32", "background": [0.0, 0.0, 0.0],
        "scene_seed": 1234,
        "camera": {"lookfrom": [478.0, 278.0, -600.0],
                   "lookat": [278.0, 278.0, 0.0], "vup": [0.0, 1.0, 0.0],
                   "vfov": 40.0, "aperture": 0.0, "focus_dist": 10.0,
                   "time0": 0.0, "time1": 1.0},
        "textures": [
            {"name": "earth", "kind": "image", "generator": "earthmap",
             "width": 1024, "height": 512},
            {"name": "pertext", "kind": "noise", "scale": 0.1},
        ],
        "materials": [
            {"name": "ground", "kind": "lambertian",
             "color": [0.48, 0.83, 0.53]},
            {"name": "light", "kind": "diffuse_light",
             "color": [7.0, 7.0, 7.0]},
            {"name": "moving", "kind": "lambertian", "color": [0.7, 0.3, 0.1]},
            {"name": "glass", "kind": "dielectric", "ir": 1.5},
            {"name": "metal", "kind": "metal", "color": [0.8, 0.8, 0.9],
             "fuzz": 1.0},
            {"name": "boundary", "kind": "dielectric", "ir": 1.5},
            {"name": "earth", "kind": "lambertian", "texture": "earth"},
            {"name": "pertext", "kind": "lambertian", "texture": "pertext"},
            {"name": "white", "kind": "lambertian",
             "color": [0.73, 0.73, 0.73]},
        ],
        "transforms": [{"name": "cluster", "rotate_y_deg": 15.0,
                        "translate": [-100.0, 270.0, 395.0]}],
        "primitives": boxes + [
            {"kind": "xz_rect", "lo": [123.0, 147.0], "hi": [423.0, 412.0],
             "k": 554.0, "material": "light"},
            {"kind": "moving_sphere", "center0": [400.0, 400.0, 200.0],
             "center1": [430.0, 400.0, 200.0], "time0": 0.0, "time1": 1.0,
             "radius": 50.0, "material": "moving"},
            {"kind": "sphere", "center": [260.0, 150.0, 45.0], "radius": 50.0,
             "material": "glass"},
            {"kind": "sphere", "center": [0.0, 150.0, 145.0], "radius": 50.0,
             "material": "metal"},
            {"kind": "sphere", "center": [360.0, 150.0, 145.0],
             "radius": 70.0, "material": "boundary"},
            {"kind": "medium_sphere", "center": [360.0, 150.0, 145.0],
             "radius": 70.0, "density": 0.2, "color": [0.2, 0.4, 0.9]},
            {"kind": "medium_sphere", "center": [0.0, 0.0, 0.0],
             "radius": 5000.0, "density": 0.0001, "color": [1.0, 1.0, 1.0]},
            {"kind": "sphere", "center": [400.0, 200.0, 400.0],
             "radius": 100.0, "material": "earth"},
            {"kind": "sphere", "center": [220.0, 280.0, 300.0],
             "radius": 80.0, "material": "pertext"},
            {"kind": "sphere", "centers": centres, "radius": 10.0,
             "material": "white", "transform": "cluster"},
        ],
        "reduced": [],
        "assumed": {
            "image": "the reference's earthmap.jpg is not in the repository: "
                     "a generated 1,024 x 512 stand-in (benchmark/inputs.py "
                     "write_earthmap)",
            "scene_seed": "the Perlin tables: drawn from default_rng(1234) "
                          "before anything else, where the library draws "
                          "them after the 400 heights",
        },
    }


def mad(prog, ref) -> float:
    return float(np.abs(prog.astype(np.int64) - ref.astype(np.int64)).mean())


# (image_mad, segments_gap) the port's float32 reaches against the float64
# reference.  Both scenes hold spheres far larger than their t_min: a ground
# of radius 1000, spheres of radius 50-100 at 400 units.  There a float32
# ray that leaves a sphere finds the same sphere again past t_min (the
# quadratic's c = |oc|^2 - r^2 cancels), so every float32 tracer, the
# reference in float32 too, traces more and longer paths: +1.1-1.6% of the
# segments on the test scene, +4.3-4.9% on the final scene at these sizes,
# where the port reads +1.1-1.6% and +3.7%.
CLOSE = {"every_key": (1.0, 3e-2), "final_scene": (2.0, 6e-2)}


@pytest.mark.parametrize("name,size", [
    ("every_key", (48, 36, 4, 8)), ("final_scene", (32, 24, 2, 8))])
def test_scene_renders_like_the_port(tmp_path, name, size):
    cfg = every_key() if name == "every_key" else final_scene()
    img, segments, ref, ref_segments = render_both(
        cfg, tmp_path, *size, seed=inputs.request_seed(3_000_000_001, 1))
    image_mad, segments_gap = CLOSE[name]
    assert mad(img, ref) <= image_mad
    assert compare.rel_gap(segments, ref_segments) <= segments_gap


def test_final_scene_holds_the_library_s_geometry(tmp_path):
    """The configuration's boxes, spheres and media are
    ``models.library.final_scene``'s, number for number."""
    from another_raytracer_tpu_torch.models import library

    cfg = final_scene()
    ours, _ = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), 32, 24,
                           "cpu")
    theirs, _ = library.final_scene(device="cpu")
    for field in ("rect_axis", "rect_k", "rect_lo", "rect_hi", "rect_xf",
                  "sph_c0", "sph_c1", "sph_t0", "sph_t1", "sph_r", "sph_xf",
                  "sph_has_uv", "med_kind", "med_a", "med_b",
                  "med_neg_inv_density", "xf_rot", "xf_trans"):
        assert torch.equal(getattr(ours, field), getattr(theirs, field)), field
    for prim in ("rect", "sph", "med"):
        kinds = [s.mat_kind[getattr(s, f"{prim}_mat").long()]
                 for s in (ours, theirs)]
        assert torch.equal(*kinds), prim


def test_perlin_tables_are_the_builder_s():
    from another_raytracer_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(seed=987654321)
    b.noise_texture(4.0)
    b.noise_texture(0.1)
    scene = b.build(device="cpu")
    ranvec, perm = perlin.tables(987654321, 2)
    assert torch.equal(scene.per_ranvec,
                       torch.from_numpy(ranvec.astype(np.float32)))
    assert torch.equal(scene.per_perm.long(), torch.from_numpy(perm))


def _scene_digest(scene) -> str:
    h = hashlib.sha256()
    for name, t in scene.tensors().items():
        t = t.detach().cpu().contiguous()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


# SceneData's tensors and the reference's image (48 x 36, spp 4, depth 8,
# request 0 of seed 3,000,000,001) and segments, as the tree before the
# language was widened built and rendered them.
PINNED = {
    "cornell_box": (
        "45487a5ad6f275ec7569aa3bed7292231d4ca821bf282202d04b767c58ddc2e5",
        "c50c918771ed96e8812a64915fe285bac193466a259c924ee8d332ec42d4af83",
        25627),
    "mesh_capsule": (
        "66ba400d40d6350ccaa9288701d72ef7dacd450e5841ab680af32f1e365aa53a",
        "e764c607fdbd4683a7f3a8bf5273564ec2566dcc0178a80783476cec168023c2",
        11459),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_accepted_configurations_are_pinned(tmp_path, name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    files = inputs.write_inputs(cfg, tmp_path)
    scene, _ = scenes.build(cfg, files, 48, 36, "cpu")
    img, segments = tracer.render(
        ref_scene.build(cfg, files, "cpu"),
        tracer.camera(cfg["camera"], 48, 36), width=48, height=36, spp=4,
        max_depth=8,
        seed=inputs.request_seed(3_000_000_001, 0))
    digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
    assert (_scene_digest(scene), digest, segments) == PINNED[name]


@pytest.mark.parametrize("section", ["textures", "materials", "primitives"])
def test_an_unknown_kind_raises(tmp_path, section):
    cfg = every_key()
    cfg[section].append({"name": "odd", "kind": "no_such_kind"})
    files = inputs.write_inputs(cfg, tmp_path)
    with pytest.raises(ValueError, match="no_such_kind"):
        scenes.build(cfg, files, 48, 36, "cpu")
    with pytest.raises(ValueError, match="no_such_kind"):
        ref_scene.build(cfg, files, "cpu")
