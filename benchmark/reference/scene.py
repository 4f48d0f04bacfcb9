"""The reference's scene: tables worked out from a configuration file and
the input files the benchmark wrote, in the float type the reference
computes in.

Textures and materials are numbered as the program's builder numbers them:
the configuration's ``textures`` in order, then each material after the
solid texture its ``color`` makes (a ``metal`` after its colour's, a
``dielectric`` after a white one), a mesh's materials at the mesh and a
medium's at the medium.  The shading leaves (``tex_ca``, ``tex_cb``,
``tex_cc``, ``mat_fuzz``, ``mat_ir``, ``atlas``, ``background``) are laid
out by those numbers, so a training step's leaves line up with the
program's by name and shape.

The closest hit walks chunks of consecutive primitives of one kind and one
transform (``Chunk``), each behind a box that holds every primitive of the
chunk in the transform's object space, grown by ``BOX_MARGIN``."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import files, perlin

LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT, ISOTROPIC = 0, 1, 2, 3, 4
SOLID, CHECKER, NOISE, IMAGE = 0, 1, 2, 3
RECT, SPHERE, TRIANGLE = 0, 1, 2  # chunk kinds, in the walk's order
MED_SPHERE, MED_BOX = 0, 1
RECT_AXES = {"yz_rect": 0, "xz_rect": 1, "xy_rect": 2}
CHUNK = 64  # primitives per chunk of the closest-hit walk
BOX_MARGIN = 1e-6  # a chunk's box grows by this, relative, against rounding


@dataclasses.dataclass
class Chunk:
    kind: int  # RECT, SPHERE or TRIANGLE
    start: int  # the chunk's primitives are start:end of its kind's tables
    end: int
    xf: int  # the transform of every primitive of the chunk
    lo: torch.Tensor  # [3] the box, in the transform's object space
    hi: torch.Tensor


@dataclasses.dataclass
class Scene:
    device: torch.device
    dtype: torch.dtype
    leaves: dict  # the shading leaves, by the program's names
    mat_kind: list
    mat_tex: torch.Tensor  # [K] int64
    tex_kind: torch.Tensor  # [T] int64
    tex_img: torch.Tensor  # [T] int64 image of an image texture
    tex_noise: torch.Tensor  # [T] int64 Perlin tables of a noise texture
    tex_scale: torch.Tensor  # [T] a noise texture's frequency
    img_off: torch.Tensor
    img_w: torch.Tensor
    img_h: torch.Tensor
    ranvec: torch.Tensor  # [Q, 256, 3] Perlin gradients
    perm: torch.Tensor  # [Q, 3, 256] int64 Perlin permutations
    xf_rot: torch.Tensor  # [M, 3, 3] world from object
    xf_trans: torch.Tensor  # [M, 3]
    rect: dict  # per-rect tensors: axis, k, lo [2], hi [2], mat, normal
    sph: dict  # per-sphere tensors: c0, c1, t0, t1, r, mat, xf, has_uv
    tri: dict  # per-triangle tensors, empty without triangles
    chunks: list  # Chunk, rects first, then spheres, then triangles
    media: list  # (kind, a [3], b [3], -1 / density, mat, xf)

    @property
    def n_tri(self) -> int:
        return 0 if not self.tri else self.tri["v0"].shape[0]

    @property
    def tex_kinds(self) -> set:
        return set(self.tex_kind.tolist())


def _rotation_y(deg: float) -> np.ndarray:
    t = math.radians(deg)
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _box_faces(p0, p1):
    """The six rects (axis, k, lo, hi) of a box, in box.cpp's order."""
    (x0, y0, z0), (x1, y1, z1) = p0, p1
    return ((2, z1, (x0, y0), (x1, y1)), (2, z0, (x0, y0), (x1, y1)),
            (1, y1, (x0, z0), (x1, z1)), (1, y0, (x0, z0), (x1, z1)),
            (0, x1, (y0, z0), (y1, z1)), (0, x0, (y0, z0), (y1, z1)))


def _rect_corners(axis, k, lo, hi):
    free = [a for a in (0, 1, 2) if a != axis]
    pts = np.zeros((2, 3))
    pts[:, axis] = k
    pts[:, free[0]] = (lo[0], hi[0])
    pts[:, free[1]] = (lo[1], hi[1])
    return pts


def _chunks(kind, xfs, points):
    """Chunks of consecutive primitives that share a transform, at most
    CHUNK long; ``points(i)`` gives [n, 3] points whose box holds primitive
    i.  Returns (kind, start, end, xf, lo, hi) numpy tuples."""
    out, start = [], 0
    while start < len(xfs):
        end = start + 1
        while (end < len(xfs) and end - start < CHUNK
               and xfs[end] == xfs[start]):
            end += 1
        pts = np.concatenate([points(i) for i in range(start, end)])
        margin = BOX_MARGIN * (1.0 + np.abs(pts).max())
        out.append((kind, start, end, xfs[start], pts.min(0) - margin,
                    pts.max(0) + margin))
        start = end
    return out


def build(config: dict, input_files: list, device, dtype=torch.float64):
    """The scene of ``config``; ``input_files`` holds what
    ``inputs.write_inputs`` wrote: the file of each ``image`` texture, in
    order, then the .obj of each ``obj_mesh`` primitive."""
    tex_kind, tex_ca, tex_cb, tex_img, tex_noise, tex_scale = ([] for _ in
                                                                range(6))
    images, noises = [], 0
    mat_kind, mat_tex, mat_fuzz, mat_ir = [], [], [], []
    inputs = iter(input_files)

    def texture(kind=SOLID, a=(0.0, 0.0, 0.0), b=(0.0, 0.0, 0.0),
                image=None, scale=0.0):
        nonlocal noises
        tex_kind.append(kind)
        tex_ca.append(a)
        tex_cb.append(b)
        tex_img.append(-1 if image is None else len(images))
        tex_noise.append(noises if kind == NOISE else -1)
        tex_scale.append(scale)
        noises += kind == NOISE
        if image is not None:
            images.append(image)
        return len(tex_kind) - 1

    def material(kind, tex, fuzz=0.0, ir=1.0):
        mat_kind.append(kind)
        mat_tex.append(tex)
        mat_fuzz.append(fuzz)
        mat_ir.append(ir)
        return len(mat_kind) - 1

    def read_image(path):
        return files.read_png(path).astype(np.float64) / 255.0

    tex_named = {}
    for t in config.get("textures", []):
        kind = t["kind"]
        if kind == "solid":
            tex_named[t["name"]] = texture(a=t["color"])
        elif kind == "checker":
            tex_named[t["name"]] = texture(CHECKER, t["even"], t["odd"])
        elif kind == "noise":
            tex_named[t["name"]] = texture(NOISE, scale=t["scale"])
        elif kind == "image":
            tex_named[t["name"]] = texture(IMAGE,
                                           image=read_image(next(inputs)))
        else:
            raise ValueError(f"the reference has no texture {kind!r}")

    def surface(m):
        return (tex_named[m["texture"]] if "texture" in m
                else texture(a=m["color"]))

    named = {}
    for m in config.get("materials", []):
        kind = m["kind"]
        if kind == "lambertian":
            named[m["name"]] = material(LAMBERTIAN, surface(m))
        elif kind == "diffuse_light":
            named[m["name"]] = material(DIFFUSE_LIGHT, surface(m))
        elif kind == "metal":  # material.h: the fuzz is at most 1
            named[m["name"]] = material(METAL, texture(a=m["color"]),
                                        fuzz=min(float(m["fuzz"]), 1.0))
        elif kind == "dielectric":
            named[m["name"]] = material(DIELECTRIC, texture(a=(1.0, 1.0, 1.0)),
                                        ir=m["ir"])
        else:
            raise ValueError(f"the reference has no material {kind!r}")
    rots, trans, xf_named = [np.eye(3)], [np.zeros(3)], {}
    for t in config.get("transforms", []):
        rots.append(_rotation_y(t["rotate_y_deg"]))
        trans.append(np.asarray(t["translate"], np.float64))
        xf_named[t["name"]] = len(rots) - 1

    cam = config["camera"]
    shutter = (float(cam.get("time0", 0.0)), float(cam.get("time1", 0.0)))
    rects, spheres, tris, media = [], [], [], []
    for p in config["primitives"]:
        kind = p["kind"]
        xf = xf_named.get(p.get("transform"), 0)
        if kind in RECT_AXES:
            rects.append((RECT_AXES[kind], p["k"], p["lo"], p["hi"],
                          named[p["material"]], xf))
        elif kind == "box":
            rects += [(*face, named[p["material"]], xf)
                      for face in _box_faces(p["p0"], p["p1"])]
        elif kind == "sphere":
            centers = p["centers"] if "centers" in p else [p["center"]]
            spheres += [(c, c, 0.0, 1.0, p["radius"], named[p["material"]],
                         xf, 1.0) for c in centers]
        elif kind == "moving_sphere":
            spheres.append((p["center0"], p["center1"], p["time0"],
                            p["time1"], p["radius"], named[p["material"]],
                            xf, 0.0))
        elif kind == "obj_mesh":
            mesh = files.read_obj(next(inputs))
            by_name = {}
            for i, name in enumerate(mesh["mat"]):
                m = mesh["mtl"].get(name) if name else None
                if m is None or not m["map_kd"]:
                    raise ValueError("the reference reads meshes whose "
                                     "faces all take a map_Kd material")
                if name not in by_name:
                    by_name[name] = material(LAMBERTIAN, texture(
                        IMAGE, image=read_image(mesh["dir"] / m["map_kd"])))
                tris.append((mesh["pos"][i], mesh["uv"][i], by_name[name]))
        elif kind in ("medium_sphere", "medium_box"):
            mat = material(ISOTROPIC, texture(a=p["color"]))
            if kind == "medium_sphere":
                a, b = p["center"], (p["radius"], 0.0, 0.0)
            else:
                a, b = p["p0"], p["p1"]
            media.append((MED_SPHERE if kind == "medium_sphere" else MED_BOX,
                          a, b, -1.0 / p["density"], mat, xf))
        else:
            raise ValueError(f"the reference has no primitive {kind!r}")
    if noises and "scene_seed" not in config:
        raise ValueError("a noise texture needs the configuration's "
                         "scene_seed")
    ranvec, perm = perlin.tables(config.get("scene_seed", 0), noises)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    if images:
        atlas = np.concatenate([im.reshape(-1, 3) for im in images])
        sizes = [(im.shape[1], im.shape[0]) for im in images]
        offs = np.cumsum([0] + [w * h for w, h in sizes[:-1]])
    else:
        atlas, sizes, offs = np.zeros((1, 3)), [(1, 1)], [0]
    leaves = {"tex_ca": t(tex_ca), "tex_cb": t(tex_cb),
              "tex_cc": t(np.zeros((len(tex_kind), 3))),
              "mat_fuzz": t(mat_fuzz), "mat_ir": t(mat_ir),
              "atlas": t(atlas), "background": t(config["background"])}

    chunks = []
    rect = {}
    if rects:
        axis = np.asarray([r[0] for r in rects])
        rect = {"axis": t(axis, torch.int64), "k": t([r[1] for r in rects]),
                "lo": t([r[2] for r in rects]), "hi": t([r[3] for r in rects]),
                "mat": t([r[4] for r in rects], torch.int64),
                # The world normal: the transform's column of the fixed axis.
                "normal": t(np.stack([rots[r[5]][:, r[0]] for r in rects]))}
        chunks += _chunks(RECT, [r[5] for r in rects],
                          lambda i: _rect_corners(*rects[i][:4]))
    sph = {}
    if spheres:
        c0 = np.asarray([s[0] for s in spheres], np.float64)
        c1 = np.asarray([s[1] for s in spheres], np.float64)
        t0 = np.asarray([s[2] for s in spheres], np.float64)
        t1 = np.asarray([s[3] for s in spheres], np.float64)
        r = np.asarray([s[4] for s in spheres], np.float64)
        sph = {"c0": t(c0), "c1": t(c1), "t0": t(t0), "t1": t(t1), "r": t(r),
               "mat": t([s[5] for s in spheres], torch.int64),
               "xf": t([s[6] for s in spheres], torch.int64),
               "has_uv": t([s[7] for s in spheres])}

        def sphere_points(i):
            # The centre at both ends of the camera's shutter: the centre
            # moves on a line, so the two hold it at every ray time.
            ends = [c0[i] + (tm - t0[i]) / (t1[i] - t0[i]) * (c1[i] - c0[i])
                    for tm in shutter]
            return np.concatenate([[e - r[i], e + r[i]] for e in ends])

        chunks += _chunks(SPHERE, [s[6] for s in spheres], sphere_points)
    tri = {}
    if tris:
        v = np.stack([x[0] for x in tris])  # [T, 3, 3]
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        n = np.cross(v1 - v0, v2 - v0)
        # Edge k's test n . ((v_k+1 - v_k) x (p - v_k)) = m_k . p - c_k with
        # m_k = n x (v_k+1 - v_k): the same number, linear in p.
        m = [np.cross(n, e) for e in (v1 - v0, v2 - v1, v0 - v2)]
        c = [np.einsum("ij,ij->i", mk, vk) for mk, vk in zip(m, (v0, v1, v2))]
        uv = np.stack([x[1] for x in tris])
        tri = {"v0": t(v0), "n": t(n), "nv0": t(np.einsum("ij,ij->i", n, v0)),
               "m": t(np.stack(m, 1)), "c": t(np.stack(c, 1)),
               "n2": t(np.einsum("ij,ij->i", n, n)), "uv": t(uv),
               "mat": t([x[2] for x in tris], torch.int64)}
        chunks += _chunks(TRIANGLE, [0] * len(tris), lambda i: v[i])
    return Scene(
        device=torch.device(device), dtype=dtype, leaves=leaves,
        mat_kind=mat_kind, mat_tex=t(mat_tex, torch.int64),
        tex_kind=t(tex_kind, torch.int64), tex_img=t(tex_img, torch.int64),
        tex_noise=t(tex_noise, torch.int64), tex_scale=t(tex_scale),
        img_off=t(offs, torch.int64), img_w=t([w for w, _ in sizes],
                                               torch.int64),
        img_h=t([h for _, h in sizes], torch.int64),
        ranvec=t(ranvec), perm=t(perm, torch.int64),
        xf_rot=t(np.stack(rots)), xf_trans=t(np.stack(trans)),
        rect=rect, sph=sph, tri=tri,
        chunks=[Chunk(k, s, e, x, t(lo), t(hi))
                for k, s, e, x, lo, hi in chunks],
        media=[(kind, t(a), t(b), float(nid), mat, xf)
               for kind, a, b, nid, mat, xf in media])
