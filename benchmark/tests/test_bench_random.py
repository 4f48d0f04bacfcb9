"""The configuration ``random``: *Ray Tracing in One Weekend*'s final
render, the book's cover (scene 1 of the reference app), written as data
by ``random_scene()`` from the draws of the program's
``models.library.random_scene`` at its seed 1234.  Held to the library's
geometry and materials, pinned by digests, and rendered by the port and
the float64 reference on the CPU at tiny sizes.

Write the file again (after a change to the generator) with:

    python -c "import sys; sys.path.insert(0, 'benchmark/tests'); \\
        import test_bench_random as t; t.write()"
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from benchmark import compare, inputs, scenes
from benchmark.reference import scene as ref_scene
from benchmark.reference import tracer
from test_bench_scenes import _scene_digest, mad, render_both

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "random.json"
SEED = 1234  # library.random_scene's default


def random_scene() -> dict:
    """Scene 1 (scene_manager.cpp:13-64) as a configuration: the checkered
    ground, the 22 x 22 grid of small spheres (a diffuse one static and
    again rising over the shutter, with one material; metal; glass) and
    the three large ones, each with a material of its own, drawn from
    ``default_rng(SEED)`` in ``models.library.add_random_spheres``' order,
    so every number is the library's."""
    gen = np.random.default_rng(SEED)
    materials = [{"name": "ground", "kind": "lambertian",
                  "texture": "checker"}]
    prims = [{"kind": "sphere", "center": [0.0, -1000.0, 0.0],
              "radius": 1000.0, "material": "ground"}]

    def material(**m):
        materials.append({"name": f"m{len(materials)}", **m})
        return materials[-1]["name"]

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = gen.uniform()
            center = np.array([a + 0.9 * gen.uniform(), 0.2,
                               c + 0.9 * gen.uniform()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = gen.uniform(0, 1, 3) * gen.uniform(0, 1, 3)
                mat = material(kind="lambertian", color=albedo.tolist())
                prims.append({"kind": "sphere", "center": center.tolist(),
                              "radius": 0.2, "material": mat})
                center2 = center + np.array([0.0, gen.uniform(0, 0.5), 0.0])
                prims.append({"kind": "moving_sphere",
                              "center0": center.tolist(),
                              "center1": center2.tolist(), "time0": 0.0,
                              "time1": 1.0, "radius": 0.2, "material": mat})
            elif choose < 0.95:
                albedo = gen.uniform(0.5, 1, 3)
                mat = material(kind="metal", color=albedo.tolist(),
                               fuzz=float(gen.uniform(0, 0.5)))
                prims.append({"kind": "sphere", "center": center.tolist(),
                              "radius": 0.2, "material": mat})
            else:
                prims.append({"kind": "sphere", "center": center.tolist(),
                              "radius": 0.2,
                              "material": material(kind="dielectric",
                                                   ir=1.5)})
    for center, m in (([0.0, 1.0, 0.0], dict(kind="dielectric", ir=1.5)),
                      ([-4.0, 1.0, 0.0], dict(kind="lambertian",
                                              color=[0.4, 0.2, 0.1])),
                      ([4.0, 1.0, 0.0], dict(kind="metal",
                                             color=[0.7, 0.6, 0.5],
                                             fuzz=0.0))):
        prims.append({"kind": "sphere", "center": center, "radius": 1.0,
                      "material": material(**m)})
    return {
        "name": "random",
        "source": "https://raytracing.github.io/books/RayTracingInOneWeekend"
                  ".html (the final render, the cover; scene 1 of "
                  "github.com/blackccpie/another_raytracer "
                  "src/scene_manager.cpp:13-64)",
        "precision": "float32", "background": [0.7, 0.8, 1.0],
        "camera": {"lookfrom": [13.0, 2.0, 3.0], "lookat": [0.0, 0.0, 0.0],
                   "vup": [0.0, 1.0, 0.0], "vfov": 20.0, "aperture": 0.1,
                   "focus_dist": 10.0, "time0": 0.0, "time1": 1.0},
        "textures": [{"name": "checker", "kind": "checker",
                      "even": [0.2, 0.3, 0.1], "odd": [0.9, 0.9, 0.9]}],
        "materials": materials,
        "primitives": prims,
        "reduced": [],
        "assumed": {
            "draws": "the generator's draws are those of "
                     "models.library.random_scene at its seed 1234 "
                     "(numpy default_rng), frozen here as numbers",
            "bvh_leaf_size": "16, the program builder's default: the "
                             "scene language has no leaf key, and the "
                             "command line builds scene 1 with leaf 32",
        },
    }


def dumps(cfg: dict) -> str:
    """The file's text: one key a line, one list entry a line."""
    lines = ["{"]
    items = list(cfg.items())
    for k, (key, value) in enumerate(items):
        end = "," if k + 1 < len(items) else ""
        if isinstance(value, list) and value and isinstance(value[0], dict):
            lines.append(f" {json.dumps(key)}: [")
            lines += [f"  {json.dumps(v)}" + ("," if j + 1 < len(value)
                                               else "")
                      for j, v in enumerate(value)]
            lines.append(f" ]{end}")
        else:
            lines.append(f" {json.dumps(key)}: {json.dumps(value)}{end}")
    return "\n".join(lines + ["}"]) + "\n"


def write() -> None:
    CONFIG.write_text(dumps(random_scene()))


def test_the_file_is_the_generator_s():
    assert CONFIG.read_text() == dumps(random_scene())
    assert json.loads(CONFIG.read_text()) == random_scene()


def test_holds_the_library_s_geometry_and_materials(tmp_path):
    """The configuration's spheres, materials and textures are
    ``models.library.random_scene``'s, number for number (its tree is
    built at leaf 32, the configuration's at the builder's 16)."""
    from another_raytracer_tpu_torch.models import library

    cfg = random_scene()
    ours, _ = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), 32, 24,
                           "cpu")
    theirs, params = library.random_scene(device="cpu")
    assert ours.n_spheres == theirs.n_spheres == 871
    assert ours.tex_ca.shape[0] == 485 and ours.bvh_leaf_size == 16
    for field in ("sph_c0", "sph_c1", "sph_t0", "sph_t1", "sph_r", "sph_xf",
                  "sph_has_uv", "sph_mat", "mat_kind", "mat_tex", "mat_fuzz",
                  "mat_ir", "tex_kind", "tex_ca", "tex_cb", "background"):
        assert torch.equal(getattr(ours, field), getattr(theirs, field)), field
    assert (ours.n_rects, ours.n_triangles, ours.n_media) == (0, 0, 0)
    for key, value in params.items():
        assert tuple(np.atleast_1d(cfg["camera"][key])) == tuple(
            np.atleast_1d(value)), key


def test_renders_like_the_port(tmp_path):
    """The port (K3's plain version on the CPU) against the float64
    reference at a tiny size: the image and the segments within the bars
    ``test_bench_scenes`` holds its sphere scenes to."""
    img, segments, ref, ref_segments = render_both(
        random_scene(), tmp_path, 32, 24, 4, 8,
        seed=inputs.request_seed(3_000_000_001, 1))
    assert mad(img, ref) <= 1.0
    assert compare.rel_gap(segments, ref_segments) <= 3e-2


# SceneData's tensors and the reference's image (48 x 36, spp 4, depth 8,
# request 0 of seed 3,000,000,001) and segments, as this configuration
# first built and rendered them.
PINNED = ("969837ce282475c1ddb508a486a6b1982bcfa4f69d5951a88a64035fc6cf1cf8",
          "cf76cd2c1b2a26d6c093c6ee133675e7679414f0c07577d0e09737a5e940c0c4",
          18888)


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
