"""The reference's scene: tables worked out from a configuration file and
the input files the benchmark wrote, in the float type the reference
computes in.

Materials and textures are numbered as a configuration lists them, each
material after its texture, a mesh's materials at the mesh and a medium's
at the medium; the shading leaves (``tex_ca``, ``tex_cb``, ``tex_cc``,
``mat_fuzz``, ``mat_ir``, ``atlas``, ``background``) are laid out by those
numbers, so a training step's leaves line up with the program's by name
and shape."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import files

LAMBERTIAN, DIFFUSE_LIGHT, ISOTROPIC = 0, 3, 4
SOLID, IMAGE = 0, 3
RECT_AXES = {"yz_rect": 0, "xz_rect": 1, "xy_rect": 2}
TRI_CHUNK = 64  # triangles per chunk of the closest-hit walk
BOX_MARGIN = 1e-6  # a chunk's box grows by this, relative, against rounding


@dataclasses.dataclass
class Scene:
    device: torch.device
    dtype: torch.dtype
    leaves: dict  # the shading leaves, by the program's names
    mat_kind: list
    mat_tex: torch.Tensor  # [K] int64
    tex_kind: torch.Tensor  # [T] int64
    tex_img: torch.Tensor  # [T] int64 image of an image texture
    img_off: torch.Tensor
    img_w: torch.Tensor
    img_h: torch.Tensor
    xf_rot: torch.Tensor  # [M, 3, 3] world from object
    xf_trans: torch.Tensor  # [M, 3]
    rects: list  # (axis, k, lo0, lo1, hi0, hi1, mat, xf) per rect
    tri: dict  # per-triangle tensors, empty without triangles
    chunks: list  # (start, end, box lo [3], box hi [3])
    media: list  # (center [3], radius, -1 / density, mat)

    @property
    def n_tri(self) -> int:
        return 0 if not self.tri else self.tri["v0"].shape[0]


def _rotation_y(deg: float) -> np.ndarray:
    t = math.radians(deg)
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def build(config: dict, mesh_paths: list, device, dtype=torch.float64):
    """The scene of ``config``; ``mesh_paths`` holds the .obj written for
    each ``obj_mesh`` primitive, in order."""
    tex_kind, tex_ca, tex_img, images = [], [], [], []
    mat_kind, mat_tex = [], []

    def texture(color=None, image=None):
        tex_kind.append(SOLID if image is None else IMAGE)
        tex_ca.append(color if image is None else (0.0, 0.0, 0.0))
        tex_img.append(-1 if image is None else len(images))
        if image is not None:
            images.append(image)
        return len(tex_kind) - 1

    def material(kind, tex):
        mat_kind.append(kind)
        mat_tex.append(tex)
        return len(mat_kind) - 1

    kinds = {"lambertian": LAMBERTIAN, "diffuse_light": DIFFUSE_LIGHT}
    named = {m["name"]: material(kinds[m["kind"]], texture(m["color"]))
             for m in config.get("materials", [])}
    rots, trans, xf_named = [np.eye(3)], [np.zeros(3)], {}
    for t in config.get("transforms", []):
        rots.append(_rotation_y(t["rotate_y_deg"]))
        trans.append(np.asarray(t["translate"], np.float64))
        xf_named[t["name"]] = len(rots) - 1

    rects, tris, media = [], [], []
    meshes = iter(mesh_paths)
    for p in config["primitives"]:
        kind = p["kind"]
        if kind in RECT_AXES:
            rects.append((RECT_AXES[kind], p["k"], *p["lo"], *p["hi"],
                          named[p["material"]],
                          xf_named.get(p.get("transform"), 0)))
        elif kind == "box":
            (x0, y0, z0), (x1, y1, z1) = p["p0"], p["p1"]
            mat, xf = named[p["material"]], xf_named.get(p.get("transform"), 0)
            for axis, k, lo, hi in ((2, z1, (x0, y0), (x1, y1)),
                                    (2, z0, (x0, y0), (x1, y1)),
                                    (1, y1, (x0, z0), (x1, z1)),
                                    (1, y0, (x0, z0), (x1, z1)),
                                    (0, x1, (y0, z0), (y1, z1)),
                                    (0, x0, (y0, z0), (y1, z1))):
                rects.append((axis, k, *lo, *hi, mat, xf))
        elif kind == "obj_mesh":
            mesh = files.read_obj(next(meshes))
            by_name = {}
            for i, name in enumerate(mesh["mat"]):
                m = mesh["mtl"].get(name) if name else None
                if m is None or not m["map_kd"]:
                    raise ValueError("the reference reads meshes whose "
                                     "faces all take a map_Kd material")
                if name not in by_name:
                    img = files.read_png(mesh["dir"] / m["map_kd"])
                    by_name[name] = material(
                        LAMBERTIAN, texture(image=img.astype(np.float64)
                                            / 255.0))
                tris.append((mesh["pos"][i], mesh["uv"][i], by_name[name]))
        elif kind == "medium_sphere":
            mat = material(ISOTROPIC, texture(p["color"]))
            media.append((p["center"], p["radius"], -1.0 / p["density"], mat))
        else:
            raise ValueError(f"the reference has no primitive {kind!r}")

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    if images:
        atlas = np.concatenate([im.reshape(-1, 3) for im in images])
        sizes = [(im.shape[1], im.shape[0]) for im in images]
        offs = np.cumsum([0] + [w * h for w, h in sizes[:-1]])
    else:
        atlas, sizes, offs = np.zeros((1, 3)), [(1, 1)], [0]
    n_tex, n_mat = len(tex_kind), len(mat_kind)
    leaves = {"tex_ca": t(tex_ca), "tex_cb": t(np.zeros((n_tex, 3))),
              "tex_cc": t(np.zeros((n_tex, 3))),
              "mat_fuzz": t(np.zeros(n_mat)), "mat_ir": t(np.ones(n_mat)),
              "atlas": t(atlas), "background": t(config["background"])}
    tri = {}
    chunks = []
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
        for s in range(0, len(tris), TRI_CHUNK):
            e = min(s + TRI_CHUNK, len(tris))
            pts = v[s:e].reshape(-1, 3)
            margin = BOX_MARGIN * (1.0 + np.abs(pts).max())
            chunks.append((s, e, t(pts.min(0) - margin),
                           t(pts.max(0) + margin)))
    return Scene(
        device=torch.device(device), dtype=dtype, leaves=leaves,
        mat_kind=mat_kind, mat_tex=t(mat_tex, torch.int64),
        tex_kind=t(tex_kind, torch.int64), tex_img=t(tex_img, torch.int64),
        img_off=t(offs, torch.int64), img_w=t([w for w, _ in sizes],
                                               torch.int64),
        img_h=t([h for _, h in sizes], torch.int64),
        xf_rot=t(np.stack(rots)), xf_trans=t(np.stack(trans)),
        rects=rects, tri=tri, chunks=chunks,
        media=[(t(c), float(r), float(nid), mat)
               for c, r, nid, mat in media])
