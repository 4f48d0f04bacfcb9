"""The canonical scenes ported so far (port of
``another_raytracer_tpu.models.library``).

Each function returns ``(SceneData, cam_params dict)`` where cam_params feeds
``ops.camera.make_camera`` (vup=(0,1,0), focus_dist=10, shutter [0,1] fixed
app-wide at src/main.cpp:33-35).  Ported: the two sweep-only scenes the
forward megakernel serves, two_spheres (2) and cornell_box (6).  The other
aliases raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import enum

from another_raytracer_tpu_torch.models.scene import SceneBuilder

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
    SceneAlias.RANDOM: "a sphere BVH (ROADMAP M16)",
    SceneAlias.TWO_PERLIN_SPHERES: "Perlin noise textures (ROADMAP M14)",
    SceneAlias.EARTH: "image textures (ROADMAP M14)",
    SceneAlias.SIMPLE_LIGHT: "Perlin noise textures (ROADMAP M14)",
    SceneAlias.CORNELL_SMOKE: "constant-density media (ROADMAP M15)",
    SceneAlias.FINAL: "BVH, media and textures (ROADMAP M14-M16)",
    SceneAlias.MESH: "triangle meshes and their BVH (ROADMAP M16-M17)",
}


def _cam(lookfrom, lookat, vfov, aperture=0.0):
    return dict(
        lookfrom=lookfrom, lookat=lookat, vup=(0.0, 1.0, 0.0), vfov=vfov,
        aperture=aperture, focus_dist=10.0, time0=0.0, time1=1.0,
    )


def two_spheres(seed: int = 1234, device="cpu"):
    b = SceneBuilder(background=SKY, seed=seed)
    checker = b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -10, 0), 10, b.lambertian(texture=checker))
    b.sphere((0, 10, 0), 10, b.lambertian(texture=checker))
    return b.build(device=device), _cam((13, 2, 3), (0, 0, 0), 20.0)


def _cornell_walls(b: SceneBuilder, light_rect, light_emit):
    red = b.lambertian(color=(0.65, 0.05, 0.05))
    white = b.lambertian(color=(0.73, 0.73, 0.73))
    green = b.lambertian(color=(0.12, 0.45, 0.15))
    light = b.diffuse_light(color=light_emit)
    b.yz_rect(0, 555, 0, 555, 555, green)
    b.yz_rect(0, 555, 0, 555, 0, red)
    b.xz_rect(*light_rect, 554, light)
    return white


def cornell_box(seed: int = 1234, device="cpu"):
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
    SceneAlias.TWO_SPHERES: two_spheres,
    SceneAlias.CORNELL_BOX: cornell_box,
}


def build(alias, seed: int = 1234, device="cpu"):
    """scene_manager::build equivalent; raises ValueError on an unknown alias
    (scene_manager.cpp:350-351) and NotImplementedError on one not ported."""
    try:
        alias = SceneAlias(int(alias))
    except ValueError as e:
        raise ValueError("unknown scene requested!") from e
    if alias not in _BUILDERS:
        raise NotImplementedError(
            f"scene {alias.value} ({alias.name.lower()}) is not ported yet: it "
            f"needs {_NOT_PORTED[alias]}; ported scenes: 2, 6")
    return _BUILDERS[alias](seed=seed, device=device)
