"""A configuration's scene and camera built through the program's input
API (``models.scene.SceneBuilder``, ``models.mesh.parse`` /
``add_to_builder``, ``ops.camera.make_camera``), so that the workload is
the configuration file's and no scene library of the program can change
it."""

from __future__ import annotations


def build(config: dict, mesh_paths: list, width: int, height: int, device):
    """(SceneData, Camera) of ``config`` for a ``width`` x ``height``
    image on ``device``."""
    from another_raytracer_tpu_torch.models import mesh as mesh_lib
    from another_raytracer_tpu_torch.models.scene import SceneBuilder
    from another_raytracer_tpu_torch.ops import camera as camera_lib

    b = SceneBuilder(background=tuple(config["background"]))
    makers = {"lambertian": b.lambertian, "diffuse_light": b.diffuse_light}
    named = {m["name"]: makers[m["kind"]](color=tuple(m["color"]))
             for m in config.get("materials", [])}
    xf = {t["name"]: b.transform(rotate_y_deg=t["rotate_y_deg"],
                                 translate=tuple(t["translate"]))
          for t in config.get("transforms", [])}
    rects = {"xy_rect": b.xy_rect, "xz_rect": b.xz_rect, "yz_rect": b.yz_rect}
    meshes = iter(mesh_paths)
    for p in config["primitives"]:
        kind = p["kind"]
        if kind in rects:
            (lo0, lo1), (hi0, hi1) = p["lo"], p["hi"]
            rects[kind](lo0, hi0, lo1, hi1, p["k"], named[p["material"]],
                        xform=xf.get(p.get("transform"), 0))
        elif kind == "box":
            b.box(p["p0"], p["p1"], named[p["material"]],
                  xform=xf.get(p.get("transform"), 0))
        elif kind == "obj_mesh":
            mesh_lib.add_to_builder(b, mesh_lib.parse(next(meshes)))
        elif kind == "medium_sphere":
            b.constant_medium_sphere(p["center"], p["radius"], p["density"],
                                     color=tuple(p["color"]))
        else:
            raise ValueError(f"unknown primitive kind {kind!r}")
    scene = b.build(device=device)
    cam = camera_lib.make_camera(aspect_ratio=width / height, device=device,
                                 **config["camera"])
    return scene, cam
