"""Wavefront .obj / .mtl ingestion into flat triangle arrays (a jax-free copy
of ``another_raytracer_tpu.models.mesh``).

Replaces the reference's rapidobj + ``mesh::build`` pipeline (mesh.h:31-145):
parse, fan-triangulate, then emit per-triangle vertex positions, per-vertex
texcoords and materials along the reference's three material paths:
  (a) mtl with map_Kd  -> textured lambertian with per-vertex texcoords
      (the barycentric_image_texture path, mesh.h:103-123),
  (b) mtl without map  -> lambertian(Ka + Kd) (mesh.h:124-130),
  (c) no materials     -> lambertian(random colour) per triangle
      (mesh.h:132-138).

``parse`` takes the native C++ parser of the port's host library
(``utils/native.py``, ``csrc/host/objparser.cpp``); the pure-Python parser
stays as its plain version (``parse(path, native=False)``), which the tests
hold it against.  The JAX package's native parser misreads a negative
texcoord index (``f -5/-4 ...``); the port's copy reads it as the Python
parser does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from another_raytracer_tpu_torch.utils import imageio


@dataclasses.dataclass
class MtlMaterial:
    name: str
    ka: tuple = (0.0, 0.0, 0.0)
    kd: tuple = (0.8, 0.8, 0.8)
    map_kd: str = ""


@dataclasses.dataclass
class MeshData:
    """Triangulated mesh: [T,3,3] vertex positions, [T,3,2] texcoords,
    [T] material ids (-1 = none), and the mtl material list."""

    tri_pos: np.ndarray
    tri_uv: np.ndarray
    tri_mat: np.ndarray
    materials: list
    work_dir: Path

    @property
    def num_triangles(self) -> int:
        return self.tri_pos.shape[0]


def _parse_mtl(path: Path) -> list:
    materials = []
    cur = None
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return materials
    for line in text.splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "newmtl":
            cur = MtlMaterial(name=parts[1] if len(parts) > 1 else "")
            materials.append(cur)
        elif cur is None:
            continue
        elif tag == "Ka" and len(parts) >= 4:
            cur.ka = tuple(float(x) for x in parts[1:4])
        elif tag == "Kd" and len(parts) >= 4:
            cur.kd = tuple(float(x) for x in parts[1:4])
        elif tag == "map_Kd" and len(parts) >= 2:
            cur.map_kd = parts[-1]
    return materials


def _parse_obj_python(path: Path):
    """Pure-Python .obj parse with fan triangulation (rapidobj::Triangulate
    fans polygons the same way)."""
    positions, texcoords = [], []
    faces = []  # (list of (vi, ti), material_id)
    materials = []
    mat_by_name = {}
    cur_mat = -1

    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        tag = parts[0]
        if tag == "v":
            positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif tag == "vt":
            texcoords.append([float(parts[1]),
                              float(parts[2]) if len(parts) > 2 else 0.0])
        elif tag == "f":
            corners = []
            for tok in parts[1:]:
                comp = tok.split("/")
                vi = int(comp[0])
                ti = int(comp[1]) if len(comp) > 1 and comp[1] else 0
                corners.append((vi, ti))
            faces.append((corners, cur_mat))
        elif tag == "mtllib":
            for m in _parse_mtl(path.parent / parts[1]):
                mat_by_name[m.name] = len(materials)
                materials.append(m)
        elif tag == "usemtl":
            cur_mat = mat_by_name.get(parts[1] if len(parts) > 1 else "", -1)

    pos = np.asarray(positions, np.float64) if positions else np.zeros((0, 3))
    uv = np.asarray(texcoords, np.float64) if texcoords else np.zeros((0, 2))

    def resolve(idx, n):
        # obj indices are 1-based; negative ones count from the end.
        return idx - 1 if idx > 0 else n + idx

    tri_pos, tri_uv, tri_mat = [], [], []
    for corners, mat in faces:
        # Fan triangulation: (0, i, i+1).
        for i in range(1, len(corners) - 1):
            tri = [corners[0], corners[i], corners[i + 1]]
            tri_pos.append([pos[resolve(vi, len(pos))] for vi, _ in tri])
            tri_uv.append([
                uv[resolve(ti, len(uv))] if ti != 0 and len(uv) else (0.0, 0.0)
                for _, ti in tri
            ])
            tri_mat.append(mat)

    return (
        np.asarray(tri_pos, np.float64).reshape(-1, 3, 3),
        np.asarray(tri_uv, np.float64).reshape(-1, 3, 2),
        np.asarray(tri_mat, np.int64).reshape(-1),
        materials,
    )


def parse(mesh_path, native: bool = True) -> MeshData:
    """Parse and triangulate an .obj with the native parser (``native``
    False: the pure-Python one).  Raises FileNotFoundError on a missing
    file, as the reference throws on a failed parse
    (scene_manager.cpp:257)."""
    path = Path(mesh_path)
    if not path.exists():
        raise FileNotFoundError(f"cannot parse mesh file: {path}")
    if native:
        from another_raytracer_tpu_torch.utils import native as native_lib

        tri_pos, tri_uv, tri_mat, mats = native_lib.parse_obj(path)
        materials = [MtlMaterial(*m) for m in mats]
    else:
        tri_pos, tri_uv, tri_mat, materials = _parse_obj_python(path)
    return MeshData(tri_pos=tri_pos, tri_uv=tri_uv, tri_mat=tri_mat,
                    materials=materials, work_dir=path.parent)


def add_to_builder(builder, mesh: MeshData):
    """Emit triangles into a SceneBuilder following mesh.h:67-145.

    Texture maps are cached per filename like material_map_handler
    (mesh.h:9-27); a missing map becomes the cyan fallback texture
    (``imageio.load_image``).  Random colours draw from ``builder.rand``
    in the JAX package's order.  Returns the number of triangles added.
    """
    tex_cache = {}

    def image_tex(map_name: str) -> int:
        if map_name not in tex_cache:
            img = imageio.load_image(mesh.work_dir / map_name)
            tex_cache[map_name] = builder.image_texture(img)
        return tex_cache[map_name]

    mat_cache = {}

    def material_for(mid: int) -> tuple:
        """Returns (material id, textured)."""
        if 0 <= mid < len(mesh.materials):
            m = mesh.materials[mid]
            if m.map_kd:
                if ("tex", mid) not in mat_cache:
                    mat_cache[("tex", mid)] = builder.lambertian(
                        texture=image_tex(m.map_kd))
                return mat_cache[("tex", mid)], True
            if ("flat", mid) not in mat_cache:
                ka, kd = np.asarray(m.ka), np.asarray(m.kd)
                mat_cache[("flat", mid)] = builder.lambertian(
                    color=tuple(ka + kd))
            return mat_cache[("flat", mid)], False
        # No materials: a random lambertian per triangle (mesh.h:132-138).
        color = tuple(builder.rand.uniform(0, 1, 3))
        return builder.lambertian(color=color), False

    for i in range(mesh.num_triangles):
        mat, textured = material_for(int(mesh.tri_mat[i]))
        builder.triangle(mesh.tri_pos[i, 0], mesh.tri_pos[i, 1],
                         mesh.tri_pos[i, 2], material=mat,
                         uvs=mesh.tri_uv[i] if textured else None)
    return mesh.num_triangles
