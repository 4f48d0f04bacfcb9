"""The nine canonical scenes (port of ``another_raytracer_tpu.models.library``).

Each function returns ``(SceneData, cam_params dict)`` where cam_params feeds
``ops.camera.make_camera`` (vup=(0,1,0), focus_dist=10, shutter [0,1] fixed
app-wide at src/main.cpp:33-35).  Scenes are built on ``device`` (default
the card).  Randomised scenes (random, final) draw from the builder's
seeded host generator in the JAX package's order, so they come out
identical.  Image assets: scenes 4 and 8 take the earthmap JPEG found
under ``ARTPU_ASSETS`` (``utils/assets.py``), else the reference's
solid-cyan fallback.
"""

from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from another_raytracer_tpu_torch.models import mesh as mesh_lib
from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.utils import assets, imageio

SKY = (0.70, 0.80, 1.00)
BLACK = (0.0, 0.0, 0.0)


class SceneAlias(enum.IntEnum):
    """scene_alias enum values 1..9 (scene_manager.h:16-27)."""

    RANDOM = 1
    TWO_SPHERES = 2
    TWO_PERLIN_SPHERES = 3
    EARTH = 4
    SIMPLE_LIGHT = 5
    CORNELL_BOX = 6
    CORNELL_SMOKE = 7
    FINAL = 8
    MESH = 9


def _cam(lookfrom, lookat, vfov, aperture=0.0):
    return dict(
        lookfrom=lookfrom, lookat=lookat, vup=(0.0, 1.0, 0.0), vfov=vfov,
        aperture=aperture, focus_dist=10.0, time0=0.0, time1=1.0,
    )


def add_random_spheres(b: SceneBuilder) -> int:
    """Adds scene 1's spheres (scene_manager.cpp:13-64) to ``b``, drawing
    from its generator, and returns how many it added.  Diffuse spheres are
    added twice: once static, once as a motion-blurred duplicate rising by
    rand(0,0.5) — both are in the reference list."""
    n = b.n_spheres
    ground = b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0, -1000, 0), 1000, ground)

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose = b.rand.uniform()
            center = np.array([a + 0.9 * b.rand.uniform(), 0.2, c + 0.9 * b.rand.uniform()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = b.rand.uniform(0, 1, 3) * b.rand.uniform(0, 1, 3)
                mat = b.lambertian(color=tuple(albedo))
                b.sphere(center, 0.2, mat)
                center2 = center + np.array([0.0, b.rand.uniform(0, 0.5), 0.0])
                b.moving_sphere(center, center2, 0.0, 1.0, 0.2, mat)
            elif choose < 0.95:
                albedo = tuple(b.rand.uniform(0.5, 1, 3))
                mat = b.metal(albedo, fuzz=b.rand.uniform(0, 0.5))
                b.sphere(center, 0.2, mat)
            else:
                b.sphere(center, 0.2, b.dielectric(1.5))

    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-4, 1, 0), 1.0, b.lambertian(color=(0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    return b.n_spheres - n


def random_scene(seed: int = 1234, device="cuda", **build_kw):
    """~500 random spheres over a checkered ground (``add_random_spheres``).
    The sphere tree uses leaf size 32, as in the JAX package (its leaf
    choice, library.py:80-84 there; set again by H100 measurement later,
    M21)."""
    b = SceneBuilder(background=SKY, seed=seed)
    add_random_spheres(b)
    build_kw = {"bvh_leaf_size": 32, **build_kw}
    return (b.build(device=device, **build_kw),
            _cam((13, 2, 3), (0, 0, 0), 20.0, aperture=0.1))


def two_spheres(seed: int = 1234, device="cuda"):
    b = SceneBuilder(background=SKY, seed=seed)
    checker = b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -10, 0), 10, b.lambertian(texture=checker))
    b.sphere((0, 10, 0), 10, b.lambertian(texture=checker))
    return b.build(device=device), _cam((13, 2, 3), (0, 0, 0), 20.0)


def two_perlin_spheres(seed: int = 1234, device="cuda"):
    b = SceneBuilder(background=SKY, seed=seed)
    pertext = b.noise_texture(4.0)
    b.sphere((0, -1000, 0), 1000, b.lambertian(texture=pertext))
    b.sphere((0, 2, 0), 2, b.lambertian(texture=pertext))
    return b.build(device=device), _cam((13, 2, 3), (0, 0, 0), 20.0)


def _earthmap():
    """The earthmap's texels, or None for the reference's missing-file
    fallback (solid cyan, texture.h:91-92)."""
    path = assets.earthmap_path()
    return imageio.load_image(path) if path is not None else None


def earth(seed: int = 1234, device="cuda", image=None):
    """A globe with an image texture.  ``image``: [h,w,3] texels (float in
    [0,1] or uint8); without one, the earthmap asset (``_earthmap``)."""
    if image is None:
        image = _earthmap()
    b = SceneBuilder(background=SKY, seed=seed)
    b.sphere((0, 0, 0), 2, b.lambertian(texture=b.image_texture(image)))
    return b.build(device=device), _cam((13, 2, 3), (0, 0, 0), 20.0)


def simple_light(seed: int = 1234, device="cuda"):
    b = SceneBuilder(background=BLACK, seed=seed)
    pertext = b.noise_texture(4.0)
    b.sphere((0, -1000, 0), 1000, b.lambertian(texture=pertext))
    b.sphere((0, 2, 0), 2, b.lambertian(texture=pertext))
    b.xy_rect(3, 5, 1, 3, -2, b.diffuse_light(color=(4, 4, 4)))
    return b.build(device=device), _cam((26, 3, 6), (0, 2, 0), 20.0)


def _cornell_walls(b: SceneBuilder, light_rect, light_emit):
    red = b.lambertian(color=(0.65, 0.05, 0.05))
    white = b.lambertian(color=(0.73, 0.73, 0.73))
    green = b.lambertian(color=(0.12, 0.45, 0.15))
    light = b.diffuse_light(color=light_emit)
    b.yz_rect(0, 555, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    b.xz_rect(*light_rect, 554, light)
    return white


def cornell_box(seed: int = 1234, device="cuda"):
    """Cornell box with two rotated boxes (scene_manager.cpp:112-139)."""
    b = SceneBuilder(background=BLACK, seed=seed)
    white = _cornell_walls(b, (213, 343, 227, 332), (15, 15, 15))
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xz_rect(0, 555, 0, 555, 555, white)
    b.xy_rect(0, 555, 0, 555, 555, white)
    xf1 = b.transform(rotate_y_deg=15, translate=(265, 0, 295))
    b.box((0, 0, 0), (165, 330, 165), white, xform=xf1)
    xf2 = b.transform(rotate_y_deg=-18, translate=(130, 0, 65))
    b.box((0, 0, 0), (165, 165, 165), white, xform=xf2)
    return b.build(device=device), _cam((278, 278, -800), (278, 278, 0), 40.0)


def cornell_smoke(seed: int = 1234, device="cuda"):
    """Cornell box with the boxes replaced by smoke volumes
    (scene_manager.cpp:141-169; dimmer, larger light)."""
    b = SceneBuilder(background=BLACK, seed=seed)
    white = _cornell_walls(b, (113, 443, 127, 432), (7, 7, 7))
    b.xz_rect(0, 555, 0, 555, 555, white)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(0, 555, 0, 555, 555, white)
    xf1 = b.transform(rotate_y_deg=15, translate=(265, 0, 295))
    b.constant_medium_box((0, 0, 0), (165, 330, 165), 0.01, color=(0, 0, 0),
                          xform=xf1)
    xf2 = b.transform(rotate_y_deg=-18, translate=(130, 0, 65))
    b.constant_medium_box((0, 0, 0), (165, 165, 165), 0.01, color=(1, 1, 1),
                          xform=xf2)
    return b.build(device=device), _cam((278, 278, -800), (278, 278, 0), 40.0)


def final_scene(seed: int = 1234, device="cuda"):
    """The Next Week final scene (scene_manager.cpp:171-234).  Leaf 48 is
    the JAX package's choice, measured on the TPU (library.py:164-167
    there); an H100 measurement is to set it (ROADMAP, the re-gates)."""
    b = SceneBuilder(background=BLACK, seed=seed)
    ground = b.lambertian(color=(0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = b.rand.uniform(1, 101)
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    b.xz_rect(123, 423, 147, 412, 554, b.diffuse_light(color=(7, 7, 7)))

    center1 = np.array([400.0, 400.0, 200.0])
    b.moving_sphere(center1, center1 + np.array([30.0, 0, 0]), 0, 1, 50,
                    b.lambertian(color=(0.7, 0.3, 0.1)))
    b.sphere((260, 150, 45), 50, b.dielectric(1.5))
    b.sphere((0, 150, 145), 50, b.metal((0.8, 0.8, 0.9), 1.0))

    # Subsurface-ish: a glass boundary around a blue medium.
    b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    b.constant_medium_sphere((360, 150, 145), 70, 0.2, color=(0.2, 0.4, 0.9))
    # Global thin mist: its giant boundary sphere is not a surface in the
    # reference, only its medium is (scene_manager.cpp:212-213).
    b.constant_medium_sphere((0, 0, 0), 5000, 1e-4, color=(1, 1, 1))

    b.sphere((400, 200, 400), 100,
             b.lambertian(texture=b.image_texture(_earthmap())))
    b.sphere((220, 280, 300), 80, b.lambertian(texture=b.noise_texture(0.1)))

    white = b.lambertian(color=(0.73, 0.73, 0.73))
    xf = b.transform(rotate_y_deg=15, translate=(-100, 270, 395))
    for _ in range(1000):
        b.sphere(b.rand.uniform(0, 165, 3), 10, white, xform=xf)
    return (b.build(device=device, bvh_leaf_size=48),
            _cam((478, 278, -600), (278, 278, 0), 40.0))


# Per-model camera presets from the reference's commented-out alternates
# (scene_manager.cpp:334-342); the active capsule view is 344-346.
_MESH_CAMERAS = {
    "dino": ((0, 15, 25), (0, 10, 0)),
    "cow": ((4, 2, 6), (2, 0, 0)),
}


def mesh_scene(seed: int = 1234, obj_path=None, device="cuda"):
    """A textured .obj mesh (default the capsule asset) + light + global
    mist (scene_manager.cpp:236-258, camera table 330-348).  Raises
    FileNotFoundError when no mesh is given and no asset is found."""
    b = SceneBuilder(background=SKY, seed=seed)
    path = obj_path or assets.capsule_obj_path()
    if path is None:
        raise FileNotFoundError(
            "cannot parse input obj file! (no mesh asset found)")
    mesh_lib.add_to_builder(b, mesh_lib.parse(path))
    b.xz_rect(123, 423, 147, 412, 554, b.diffuse_light(color=(7, 7, 7)))
    b.constant_medium_sphere((0, 0, 0), 5000, 1e-4, color=(1, 1, 1))
    lookfrom, lookat = _MESH_CAMERAS.get(Path(path).stem,
                                         ((2, 2, 1), (0, 0, 0)))
    return b.build(device=device), _cam(lookfrom, lookat, 75.0)


_BUILDERS = {
    SceneAlias.RANDOM: random_scene,
    SceneAlias.TWO_SPHERES: two_spheres,
    SceneAlias.TWO_PERLIN_SPHERES: two_perlin_spheres,
    SceneAlias.EARTH: earth,
    SceneAlias.SIMPLE_LIGHT: simple_light,
    SceneAlias.CORNELL_BOX: cornell_box,
    SceneAlias.CORNELL_SMOKE: cornell_smoke,
    SceneAlias.FINAL: final_scene,
    SceneAlias.MESH: mesh_scene,
}


def build(alias, seed: int = 1234, device="cuda"):
    """scene_manager::build equivalent; raises ValueError on an unknown alias
    (scene_manager.cpp:350-351)."""
    try:
        alias = SceneAlias(int(alias))
    except ValueError as e:
        raise ValueError("unknown scene requested!") from e
    return _BUILDERS[alias](seed=seed, device=device)
