"""The canonical scenes ported so far (port of
``another_raytracer_tpu.models.library``).

Each function returns ``(SceneData, cam_params dict)`` where cam_params feeds
``ops.camera.make_camera`` (vup=(0,1,0), focus_dist=10, shutter [0,1] fixed
app-wide at src/main.cpp:33-35).  Scenes are built on ``device`` (default
the card).  Ported: random (1), two_spheres (2), two_perlin_spheres (3),
earth (4), simple_light (5) and cornell_box (6).  The other aliases raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import enum

import numpy as np

from another_raytracer_tpu_torch.models.scene import SceneBuilder
from another_raytracer_tpu_torch.utils import assets

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


# What each unported alias waits for (ROADMAP.md, Queue 1).
_NOT_PORTED = {
    SceneAlias.CORNELL_SMOKE: "constant-density media (ROADMAP M15)",
    SceneAlias.FINAL: "constant-density media (ROADMAP M15)",
    SceneAlias.MESH: "the .obj mesh loader (ROADMAP M17)",
}


def _cam(lookfrom, lookat, vfov, aperture=0.0):
    return dict(
        lookfrom=lookfrom, lookat=lookat, vup=(0.0, 1.0, 0.0), vfov=vfov,
        aperture=aperture, focus_dist=10.0, time0=0.0, time1=1.0,
    )


def random_scene(seed: int = 1234, device="cuda", **build_kw):
    """~500 random spheres over a checkered ground (scene_manager.cpp:13-64).
    Diffuse spheres are added twice: once static, once as a motion-blurred
    duplicate rising by rand(0,0.5) — both are in the reference list.  The
    sphere tree uses leaf size 32, as in the JAX package (its leaf choice,
    library.py:80-84 there; set again by H100 measurement later, M21)."""
    b = SceneBuilder(background=SKY, seed=seed)
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


def earth(seed: int = 1234, device="cuda", image=None):
    """A globe with an image texture.  ``image``: [h,w,3] texels (float in
    [0,1] or uint8).  Without one, the earthmap asset: when none is found,
    the reference's missing-file fallback (solid cyan, texture.h:91-92); a
    found one needs a JPEG decoder the port does not have yet."""
    if image is None:
        path = assets.earthmap_path()
        if path is not None:
            raise NotImplementedError(
                f"found the earthmap at {path}, but decoding JPEG is not "
                "ported yet (ROADMAP M20); pass image= with decoded texels")
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


_BUILDERS = {
    SceneAlias.RANDOM: random_scene,
    SceneAlias.TWO_SPHERES: two_spheres,
    SceneAlias.TWO_PERLIN_SPHERES: two_perlin_spheres,
    SceneAlias.EARTH: earth,
    SceneAlias.SIMPLE_LIGHT: simple_light,
    SceneAlias.CORNELL_BOX: cornell_box,
}
PORTED = tuple(int(a) for a in _BUILDERS)


def build(alias, seed: int = 1234, device="cuda"):
    """scene_manager::build equivalent; raises ValueError on an unknown alias
    (scene_manager.cpp:350-351) and NotImplementedError on one not ported."""
    try:
        alias = SceneAlias(int(alias))
    except ValueError as e:
        raise ValueError("unknown scene requested!") from e
    if alias not in _BUILDERS:
        raise NotImplementedError(
            f"scene {alias.value} ({alias.name.lower()}) is not ported yet: it "
            f"needs {_NOT_PORTED[alias]}; ported scenes: "
            f"{', '.join(map(str, PORTED))}")
    return _BUILDERS[alias](seed=seed, device=device)
