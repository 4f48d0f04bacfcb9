"""A configuration's scene and camera built through the program's input
API (``models.scene.SceneBuilder``, ``models.mesh.parse`` /
``add_to_builder``, ``utils.imageio.load_image``,
``ops.camera.make_camera``), so that the workload is the configuration
file's and no scene library of the program can change it.

The builder's generator, seeded by the configuration's ``scene_seed``, is
used by the noise textures alone, in the order ``textures`` lists them."""

from __future__ import annotations


def build(config: dict, input_files: list, width: int, height: int, device):
    """(SceneData, Camera) of ``config`` for a ``width`` x ``height``
    image on ``device``; ``input_files`` as ``inputs.write_inputs`` wrote
    them."""
    from another_raytracer_tpu_torch.models import mesh as mesh_lib
    from another_raytracer_tpu_torch.models.scene import SceneBuilder
    from another_raytracer_tpu_torch.ops import camera as camera_lib
    from another_raytracer_tpu_torch.utils import imageio

    seed = {"seed": config["scene_seed"]} if "scene_seed" in config else {}
    b = SceneBuilder(background=tuple(config["background"]), **seed)
    inputs = iter(input_files)
    textures = {}
    for t in config.get("textures", []):
        kind = t["kind"]
        if kind == "solid":
            textures[t["name"]] = b.solid_texture(tuple(t["color"]))
        elif kind == "checker":
            textures[t["name"]] = b.checker_texture(tuple(t["even"]),
                                                    tuple(t["odd"]))
        elif kind == "noise":
            textures[t["name"]] = b.noise_texture(t["scale"])
        elif kind == "image":
            textures[t["name"]] = b.image_texture(
                imageio.load_image(next(inputs)))
        else:
            raise ValueError(f"unknown texture kind {kind!r}")

    def surface(m):
        if "texture" in m:
            return {"texture": textures[m["texture"]]}
        return {"color": tuple(m["color"])}

    named = {}
    for m in config.get("materials", []):
        kind = m["kind"]
        if kind == "lambertian":
            named[m["name"]] = b.lambertian(**surface(m))
        elif kind == "diffuse_light":
            named[m["name"]] = b.diffuse_light(**surface(m))
        elif kind == "metal":
            named[m["name"]] = b.metal(tuple(m["color"]), fuzz=m["fuzz"])
        elif kind == "dielectric":
            named[m["name"]] = b.dielectric(m["ir"])
        else:
            raise ValueError(f"unknown material kind {kind!r}")
    xf = {t["name"]: b.transform(rotate_y_deg=t["rotate_y_deg"],
                                 translate=tuple(t["translate"]))
          for t in config.get("transforms", [])}
    rects = {"xy_rect": b.xy_rect, "xz_rect": b.xz_rect, "yz_rect": b.yz_rect}
    for p in config["primitives"]:
        kind = p["kind"]
        mat = named[p["material"]] if "material" in p else None
        xform = xf.get(p.get("transform"), 0)
        if kind in rects:
            (lo0, lo1), (hi0, hi1) = p["lo"], p["hi"]
            rects[kind](lo0, hi0, lo1, hi1, p["k"], mat, xform=xform)
        elif kind == "box":
            b.box(p["p0"], p["p1"], mat, xform=xform)
        elif kind == "sphere":
            for c in p["centers"] if "centers" in p else [p["center"]]:
                b.sphere(c, p["radius"], mat, xform=xform)
        elif kind == "moving_sphere":
            b.moving_sphere(p["center0"], p["center1"], p["time0"],
                            p["time1"], p["radius"], mat, xform=xform)
        elif kind == "obj_mesh":
            mesh_lib.add_to_builder(b, mesh_lib.parse(next(inputs)))
        elif kind == "medium_sphere":
            b.constant_medium_sphere(p["center"], p["radius"], p["density"],
                                     color=tuple(p["color"]), xform=xform)
        elif kind == "medium_box":
            b.constant_medium_box(p["p0"], p["p1"], p["density"],
                                  color=tuple(p["color"]), xform=xform)
        else:
            raise ValueError(f"unknown primitive kind {kind!r}")
    scene = b.build(device=device)
    cam = camera_lib.make_camera(aspect_ratio=width / height, device=device,
                                 **config["camera"])
    return scene, cam
