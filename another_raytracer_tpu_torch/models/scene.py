"""Flat SoA scene representation + host-side builder (port of
``another_raytracer_tpu.models.scene``).

A scene is one dataclass of flat tensors — structure-of-arrays per primitive
kind, plus material / texture / transform / image-atlas / Perlin tables —
built host-side in float64 NumPy and cast to float32 at the end.  Field
names, kind constants and static fields are the JAX package's, so
``scene_from_reference`` can carry a JAX-built scene across leaf by leaf.

Left out on purpose (TPU-only, ROADMAP M21): ``atlas_packed`` /
``atlas_exact_u8`` (8:8:8 packed texels for the TPU's slow gathers),
``use_pallas_bvh`` and ``bvh_block`` (Mosaic block sizes): every BVH here is
traversed by the BVH kernel K5 (``ops/kernels/bvh_kernel.py``) or, on the
CPU, its plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from another_raytracer_tpu_torch.models import bvh as bvh_lib
from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

# --- kind constants --------------------------------------------------------

PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRIANGLE = 2
PRIM_MEDIUM = 3

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2
TEX_IMAGE = 3
TEX_BARYCENTRIC = 4

MED_SPHERE = 0
MED_BOX = 1

PERLIN_POINT_COUNT = 256

# Static (non-tensor) fields, in declaration order.
STATIC_FIELDS = (
    "n_spheres", "n_rects", "n_triangles", "n_media", "n_bvh_nodes",
    "n_rect_bvh_nodes", "n_sph_bvh_nodes", "tri_in_bvh", "rect_in_bvh",
    "sph_in_bvh", "sph_fold_safe", "mat_kinds", "tex_kinds", "bvh_leaf_size",
    "has_motion",
)


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat scene; float tensors are float32, index tensors int32.  Shapes
    and meanings as in the JAX package's SceneData."""

    # Spheres (static and moving unified; a static sphere has c1 == c0).
    sph_c0: torch.Tensor  # [Ns,3] center at t0
    sph_c1: torch.Tensor  # [Ns,3] center at t1
    sph_t0: torch.Tensor  # [Ns]
    sph_t1: torch.Tensor  # [Ns]
    sph_r: torch.Tensor  # [Ns]
    sph_mat: torch.Tensor  # [Ns] int32
    sph_xf: torch.Tensor  # [Ns] int32
    sph_has_uv: torch.Tensor  # [Ns] float32 (1.0 static / 0.0 moving)

    # Axis-aligned rects: ``axis`` is the fixed coordinate (0=x yz_rect,
    # 1=y xz_rect, 2=z xy_rect); lo/hi bound the two free coordinates in
    # ascending axis order.
    rect_axis: torch.Tensor  # [Nr] int32
    rect_k: torch.Tensor  # [Nr]
    rect_lo: torch.Tensor  # [Nr,2]
    rect_hi: torch.Tensor  # [Nr,2]
    rect_mat: torch.Tensor  # [Nr] int32
    rect_xf: torch.Tensor  # [Nr] int32

    # Triangles with per-vertex texcoords.
    tri_v0: torch.Tensor  # [Nt,3]
    tri_v1: torch.Tensor  # [Nt,3]
    tri_v2: torch.Tensor  # [Nt,3]
    tri_uv0: torch.Tensor  # [Nt,2]
    tri_uv1: torch.Tensor  # [Nt,2]
    tri_uv2: torch.Tensor  # [Nt,2]
    tri_mat: torch.Tensor  # [Nt] int32
    tri_xf: torch.Tensor  # [Nt] int32

    # Constant-density media with analytic boundaries.
    med_kind: torch.Tensor  # [Nm] int32 (MED_SPHERE / MED_BOX)
    med_a: torch.Tensor  # [Nm,3] center (sphere) or box min
    med_b: torch.Tensor  # [Nm,3] (radius,0,0) (sphere) or box max
    med_neg_inv_density: torch.Tensor  # [Nm]
    med_mat: torch.Tensor  # [Nm] int32
    med_xf: torch.Tensor  # [Nm] int32

    # Transform table: world-from-object rotation + translation; id 0 = identity.
    xf_rot: torch.Tensor  # [M,3,3]
    xf_trans: torch.Tensor  # [M,3]

    # Material table.
    mat_kind: torch.Tensor  # [K] int32
    mat_tex: torch.Tensor  # [K] int32
    mat_fuzz: torch.Tensor  # [K]
    mat_ir: torch.Tensor  # [K]

    # Texture table.
    tex_kind: torch.Tensor  # [T] int32
    tex_ca: torch.Tensor  # [T,3]
    tex_cb: torch.Tensor  # [T,3]
    tex_cc: torch.Tensor  # [T,3]
    tex_scale: torch.Tensor  # [T]
    tex_aux: torch.Tensor  # [T] int32

    # Image atlas: all texel rows concatenated; per image (offset, w, h).
    atlas: torch.Tensor  # [P,3]
    img_off: torch.Tensor  # [I] int32
    img_w: torch.Tensor  # [I] int32
    img_h: torch.Tensor  # [I] int32

    # Perlin tables, one instance per noise texture.
    per_ranvec: torch.Tensor  # [Q,256,3]
    per_perm: torch.Tensor  # [Q,3,256] int32

    background: torch.Tensor  # [3]

    # BVH arrays (models/bvh.py, packed by ops/kernels/bvh_kernel.py); empty
    # when the scene has no BVH.  The planar tree holds triangles and the
    # quad-split transformed rects; identity rects and spheres have their own.
    bvh_node_min: torch.Tensor  # [M,3]
    bvh_node_max: torch.Tensor  # [M,3]
    bvh_escape: torch.Tensor  # [M] int32
    bvh_leaf_first: torch.Tensor  # [M] int32
    bvh_leaf_count: torch.Tensor  # [M] int32
    bvh_prim_order: torch.Tensor  # [N] int32
    bvh_packed_nodes: torch.Tensor  # [M,8]
    bvh_packed_tris: torch.Tensor  # [N+pad,35] ([0,24] when empty)
    rect_bvh_nodes: torch.Tensor  # [Mr,8]
    rect_bvh_rows: torch.Tensor  # [Nr+pad,16]
    sph_bvh_nodes: torch.Tensor  # [Ms,8]
    sph_bvh_rows: torch.Tensor  # [Ns+pad,16]

    # --- static metadata ---------------------------------------------------
    n_spheres: int = 0
    n_rects: int = 0
    n_triangles: int = 0
    n_media: int = 0
    n_bvh_nodes: int = 0
    n_rect_bvh_nodes: int = 0
    n_sph_bvh_nodes: int = 0
    tri_in_bvh: bool = False
    rect_in_bvh: bool = False
    sph_in_bvh: bool = False
    sph_fold_safe: bool = True
    # Which material/texture kinds appear — gates shading code paths.
    mat_kinds: tuple = ()
    tex_kinds: tuple = ()
    bvh_leaf_size: int = 16
    # Any moving sphere?  When False the camera skips the shutter-time draw.
    has_motion: bool = True

    @property
    def num_primitives(self) -> int:
        return self.n_spheres + self.n_rects + self.n_triangles + self.n_media

    @property
    def has_accel(self) -> bool:
        """Any BVH present."""
        return bool(self.n_bvh_nodes or self.n_rect_bvh_nodes
                    or self.n_sph_bvh_nodes)

    @property
    def device(self) -> torch.device:
        return self.background.device

    def tensors(self) -> dict:
        """Tensor fields by name."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in STATIC_FIELDS}

    def to(self, device) -> "SceneData":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.tensors().items()})

    def replace(self, **fields) -> "SceneData":
        """A copy with ``fields`` swapped in (the JAX SceneData.replace that
        grad/diff.merge_params uses); tensors keep their autograd history."""
        return dataclasses.replace(self, **fields)


def scene_from_reference(obj, device="cpu") -> SceneData:
    """Carry a JAX-package SceneData across: ``np.asarray`` on every leaf the
    port keeps, static fields copied.  Reads attributes only; imports no JAX."""
    kw = {}
    for f in dataclasses.fields(SceneData):
        v = getattr(obj, f.name)
        if f.name in STATIC_FIELDS:
            kw[f.name] = tuple(v) if isinstance(v, (tuple, list)) else v
        else:
            kw[f.name] = torch.from_numpy(np.array(np.asarray(v))).to(device)
    return SceneData(**kw)


@dataclasses.dataclass
class _Image:
    texels: np.ndarray  # [h, w, 3] float in [0,1]


def rotation_y(degrees: float) -> np.ndarray:
    """World-from-object rotation about +y (reference: rotate_y,
    hittable.cpp:25-85: object->world is x' = c*x + s*z, z' = -s*x + c*z)."""
    t = math.radians(degrees)
    c, s = math.cos(t), math.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=np.float64)


def _rect_quads(rects, ids, rots, trans):
    """Axis-rects (the given original indices) -> two WORLD-space triangles
    each, for the planar BVH's winner search.  Used only for rects with
    NON-identity transforms (identity ones get native axis-rect rows in
    their own tree).  Corners are computed in object space with the free-axis
    order of ops/intersect._rect_t (axis 0 -> (1,2), 1 -> (0,2), 2 -> (0,1))
    and baked through the rect's world-from-object transform.  Returns
    (v0, v1, v2 [2N,3], codes [2N]); both triangles of rect i carry code
    i*4 + PRIM_RECT, so the winner decodes to the rect id and the hit record
    is recomputed from the original rect.  Known edge (as in the JAX
    package): a degenerate rect is hittable by the sweep but not by its
    zero-normal triangles, and rays crossing the shared diagonal can miss
    both triangles at f32-ulp level."""
    n = len(ids)
    v0 = np.zeros((2 * n, 3))
    v1 = np.zeros((2 * n, 3))
    v2 = np.zeros((2 * n, 3))
    codes = np.zeros((2 * n,), np.int64)
    for j, i in enumerate(ids):
        axis, k, lo, hi, _mat, xf = rects[i]
        au = 1 if axis == 0 else 0
        av = 1 if axis == 2 else 2
        rot, tr = rots[xf], trans[xf]

        def pt(u, v):
            p = np.zeros(3)
            p[axis] = k
            p[au] = u
            p[av] = v
            return rot @ p + tr

        p00, p10 = pt(lo[0], lo[1]), pt(hi[0], lo[1])
        p11, p01 = pt(hi[0], hi[1]), pt(lo[0], hi[1])
        v0[2 * j], v1[2 * j], v2[2 * j] = p00, p10, p11
        v0[2 * j + 1], v1[2 * j + 1], v2[2 * j + 1] = p00, p11, p01
        codes[2 * j] = codes[2 * j + 1] = i * 4 + PRIM_RECT
    return v0, v1, v2, codes


class SceneBuilder:
    """Host-side scene construction producing a :class:`SceneData`.

    The same builder API and the same float64 numpy construction as the JAX
    package's SceneBuilder (so seeded scenes come out identical); only the
    final cast differs.
    """

    def __init__(self, background=(0.0, 0.0, 0.0), seed: int = 1234):
        self.background = np.asarray(background, np.float64)
        # Host RNG used for scene randomness (random scenes, perlin tables).
        self.rand = np.random.default_rng(seed)

        self._spheres = []  # (c0, c1, t0, t1, r, mat, xf, has_uv)
        self._rects = []  # (axis, k, lo2, hi2, mat, xf)
        self._tris = []  # (v0, v1, v2, uv0, uv1, uv2, mat, xf)
        self._media = []  # (kind, a3, b3, neg_inv_density, mat, xf)
        self._xforms = [(np.eye(3), np.zeros(3))]  # id 0 = identity
        self._materials = []  # (kind, tex, fuzz, ir)
        self._textures = []  # (kind, ca, cb, cc, scale, aux)
        self._images: list[_Image] = []
        self._perlins = []  # (ranvec [256,3], perm [3,256])

    # --- transforms -------------------------------------------------------

    def transform(self, rotate_y_deg: float = 0.0, translate=(0.0, 0.0, 0.0)) -> int:
        """Register a world-from-object transform: first rotate about y, then
        translate (scene_manager.cpp:129-137)."""
        rot = rotation_y(rotate_y_deg)
        tr = np.asarray(translate, np.float64)
        if rotate_y_deg == 0.0 and not tr.any():
            return 0
        self._xforms.append((rot, tr))
        return len(self._xforms) - 1

    # --- textures ---------------------------------------------------------

    def _add_texture(self, kind, ca=(0, 0, 0), cb=(0, 0, 0), cc=(0, 0, 0), scale=0.0, aux=-1) -> int:
        self._textures.append(
            (kind, np.asarray(ca, np.float64), np.asarray(cb, np.float64),
             np.asarray(cc, np.float64), float(scale), int(aux))
        )
        return len(self._textures) - 1

    def solid_texture(self, color) -> int:
        return self._add_texture(TEX_SOLID, ca=color)

    def checker_texture(self, even, odd) -> int:
        """3D sin-product checker (texture.h:39-45)."""
        return self._add_texture(TEX_CHECKER, ca=even, cb=odd)

    def noise_texture(self, scale: float) -> int:
        """Grayscale Perlin 0.5*(1+noise(scale*p)) (texture.h:57-59); a fresh
        Perlin instance with its own random tables per call."""
        ranvec = self.rand.uniform(-1.0, 1.0, size=(PERLIN_POINT_COUNT, 3))
        ranvec /= np.linalg.norm(ranvec, axis=-1, keepdims=True)
        perm = np.stack(
            [self.rand.permutation(PERLIN_POINT_COUNT) for _ in range(3)]
        ).astype(np.int32)
        self._perlins.append((ranvec, perm))
        return self._add_texture(TEX_NOISE, scale=scale, aux=len(self._perlins) - 1)

    def image_texture(self, image) -> int:
        """Image-mapped texture from an [h,w,3] float array in [0,1], an
        [h,w,3] uint8 array, or None (the reference's missing-file fallback:
        solid cyan, texture.h:91-92)."""
        if image is None:
            texels = np.full((1, 1, 3), (0.0, 1.0, 1.0), np.float64)
        else:
            texels = np.asarray(image, np.float64)
            if texels.dtype != np.float64 or texels.max() > 1.0 + 1e-6:
                texels = np.asarray(image, np.float64) / 255.0
            if texels.ndim == 2:
                texels = np.repeat(texels[..., None], 3, axis=-1)
            texels = texels[..., :3]
        self._images.append(_Image(texels))
        return self._add_texture(TEX_IMAGE, aux=len(self._images) - 1)

    def barycentric_texture(self, a, b, c) -> int:
        """u*A + v*B + (1-u-v)*C blend over triangle barycentrics."""
        return self._add_texture(TEX_BARYCENTRIC, ca=a, cb=b, cc=c)

    def _tex_id(self, color=None, texture=None) -> int:
        if (color is None) == (texture is None):
            raise ValueError("exactly one of color/texture required")
        return self.solid_texture(color) if texture is None else texture

    # --- materials --------------------------------------------------------

    def _add_material(self, kind, tex=0, fuzz=0.0, ir=1.0) -> int:
        self._materials.append((kind, int(tex), float(fuzz), float(ir)))
        return len(self._materials) - 1

    def lambertian(self, color=None, texture=None) -> int:
        return self._add_material(MAT_LAMBERTIAN, tex=self._tex_id(color, texture))

    def metal(self, color, fuzz=0.0) -> int:
        # fuzz clamped to <= 1 in the reference ctor (material.h:47)
        return self._add_material(
            MAT_METAL, tex=self.solid_texture(color), fuzz=min(float(fuzz), 1.0)
        )

    def dielectric(self, index_of_refraction: float) -> int:
        return self._add_material(MAT_DIELECTRIC, tex=self.solid_texture((1, 1, 1)), ir=index_of_refraction)

    def diffuse_light(self, color=None, texture=None) -> int:
        return self._add_material(MAT_DIFFUSE_LIGHT, tex=self._tex_id(color, texture))

    def isotropic(self, color=None, texture=None) -> int:
        return self._add_material(MAT_ISOTROPIC, tex=self._tex_id(color, texture))

    # --- primitives -------------------------------------------------------

    def sphere(self, center, radius, material: int, xform: int = 0):
        c = np.asarray(center, np.float64)
        self._spheres.append((c, c, 0.0, 1.0, float(radius), material, xform, 1.0))

    def moving_sphere(self, center0, center1, time0, time1, radius, material: int, xform: int = 0):
        self._spheres.append(
            (np.asarray(center0, np.float64), np.asarray(center1, np.float64),
             float(time0), float(time1), float(radius), material, xform, 0.0)
        )

    def _rect(self, axis, k, lo, hi, material, xform):
        self._rects.append(
            (axis, float(k), np.asarray(lo, np.float64), np.asarray(hi, np.float64),
             material, xform)
        )

    def xy_rect(self, x0, x1, y0, y1, k, material: int, xform: int = 0):
        self._rect(2, k, (x0, y0), (x1, y1), material, xform)

    def xz_rect(self, x0, x1, z0, z1, k, material: int, xform: int = 0):
        self._rect(1, k, (x0, z0), (x1, z1), material, xform)

    def yz_rect(self, y0, y1, z0, z1, k, material: int, xform: int = 0):
        self._rect(0, k, (y0, z0), (y1, z1), material, xform)

    def box(self, p0, p1, material: int, xform: int = 0):
        """Axis-aligned box as 6 rects (reference: box.cpp:3-15)."""
        x0, y0, z0 = np.asarray(p0, np.float64)
        x1, y1, z1 = np.asarray(p1, np.float64)
        self.xy_rect(x0, x1, y0, y1, z1, material, xform)
        self.xy_rect(x0, x1, y0, y1, z0, material, xform)
        self.xz_rect(x0, x1, z0, z1, y1, material, xform)
        self.xz_rect(x0, x1, z0, z1, y0, material, xform)
        self.yz_rect(y0, y1, z0, z1, x1, material, xform)
        self.yz_rect(y0, y1, z0, z1, x0, material, xform)

    def triangle(self, v0, v1, v2, material: int, uvs: Optional[Sequence] = None, xform: int = 0):
        if uvs is None:
            uvs = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
        self._tris.append(
            (np.asarray(v0, np.float64), np.asarray(v1, np.float64),
             np.asarray(v2, np.float64),
             np.asarray(uvs[0], np.float64), np.asarray(uvs[1], np.float64),
             np.asarray(uvs[2], np.float64), material, xform)
        )

    def constant_medium_sphere(self, center, radius, density, color=None, texture=None, xform: int = 0):
        mat = self.isotropic(color=color, texture=texture)
        self._media.append(
            (MED_SPHERE, np.asarray(center, np.float64),
             np.array([radius, 0.0, 0.0]), -1.0 / density, mat, xform)
        )

    def constant_medium_box(self, p0, p1, density, color=None, texture=None, xform: int = 0):
        mat = self.isotropic(color=color, texture=texture)
        self._media.append(
            (MED_BOX, np.asarray(p0, np.float64), np.asarray(p1, np.float64),
             -1.0 / density, mat, xform)
        )

    # --- assembly ---------------------------------------------------------

    # Thresholds of the 'auto' BVH choice (the JAX builder's): a kind with at
    # least this many primitives is traversed through a BVH, fewer through
    # the [B, N] sweep.
    BVH_AUTO_THRESHOLD = 64
    RECT_BVH_THRESHOLD = 64
    SPHERE_BVH_THRESHOLD = 64

    def build(self, device="cuda", bvh="auto", bvh_leaf_size: int = 16,
              rect_bvh="auto", sphere_bvh="auto") -> SceneData:
        """Cast to float32 / int32 tensors on ``device`` (default the card;
        ``"cpu"`` for the plain versions).  ``bvh`` / ``rect_bvh`` /
        ``sphere_bvh``: True, False or 'auto' (above the thresholds), as in
        the JAX builder; ``bvh_leaf_size`` is the leaf size of every tree."""
        def f(x, shape):
            a = np.asarray(x, np.float64).reshape(shape).astype(np.float32)
            return torch.from_numpy(a).to(device)

        def i32(x, shape):
            a = np.asarray(x, np.int64).reshape(shape).astype(np.int32)
            return torch.from_numpy(a).to(device)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        ns, nr, nt, nm = map(len, (self._spheres, self._rects, self._tris, self._media))

        want_bvh = (bvh is True) or (bvh == "auto" and nt >= self.BVH_AUTO_THRESHOLD)
        tri_xf_all_identity = nt == 0 or all(int(x[7]) == 0 for x in self._tris)
        tri_in_bvh = want_bvh and nt > 0 and tri_xf_all_identity
        rect_in_bvh = nr > 0 and (
            rect_bvh is True
            or (rect_bvh == "auto" and bvh is not False
                and nr >= self.RECT_BVH_THRESHOLD))
        sph_in_bvh = ns > 0 and (
            sphere_bvh is True
            or (sphere_bvh == "auto" and bvh is not False
                and ns >= self.SPHERE_BVH_THRESHOLD))

        sph = list(zip(*self._spheres)) if ns else [[]] * 8
        rect = list(zip(*self._rects)) if nr else [[]] * 6
        tri = list(zip(*self._tris)) if nt else [[]] * 8
        med = list(zip(*self._media)) if nm else [[]] * 6

        if not self._materials:
            self._add_material(MAT_LAMBERTIAN, tex=self.solid_texture((0.5, 0.5, 0.5)))
        mats = list(zip(*self._materials))
        texs = list(zip(*self._textures))

        # Image atlas.
        if self._images:
            offs, ws, hs, rows = [], [], [], []
            off = 0
            for im in self._images:
                h, w = im.texels.shape[:2]
                offs.append(off)
                ws.append(w)
                hs.append(h)
                rows.append(im.texels.reshape(-1, 3))
                off += h * w
            atlas = np.concatenate(rows, axis=0)
        else:
            offs, ws, hs = [0], [1], [1]
            atlas = np.zeros((1, 3))

        if self._perlins:
            ranvec = np.stack([p[0] for p in self._perlins])
            perm = np.stack([p[1] for p in self._perlins])
        else:
            ranvec = np.zeros((1, PERLIN_POINT_COUNT, 3))
            perm = np.tile(np.arange(PERLIN_POINT_COUNT, dtype=np.int32), (1, 3, 1))

        rots = np.stack([x[0] for x in self._xforms])
        trans = np.stack([x[1] for x in self._xforms])

        empty_f = lambda *shape: f(np.zeros(shape), shape)  # noqa: E731
        empty_i = i32(np.zeros((0,)), (0,))
        bvh_arrays = dict(
            bvh_node_min=empty_f(0, 3), bvh_node_max=empty_f(0, 3),
            bvh_escape=empty_i, bvh_leaf_first=empty_i,
            bvh_leaf_count=empty_i, bvh_prim_order=empty_i,
            bvh_packed_nodes=empty_f(0, 8), bvh_packed_tris=empty_f(0, 24),
            rect_bvh_nodes=empty_f(0, 8), rect_bvh_rows=empty_f(0, 16),
            sph_bvh_nodes=empty_f(0, 8), sph_bvh_rows=empty_f(0, 16))
        n_bvh = n_rect_bvh = n_sph_bvh = 0

        # --- BVH acceleration (host build, models/bvh.py) -----------------
        # Planar tree: triangles (identity transforms only) plus accelerated
        # rects with transforms, each baked to two world-space triangles for
        # the winner search.  Identity rects: a tree of native axis-rect
        # rows.  Sphere tree: world-baked centers (a rigid transform maps a
        # sphere to a sphere and commutes with the center lerp).
        rect_native_ids = [i for i, rc in enumerate(self._rects) if rc[5] == 0]
        rect_quad_ids = [i for i, rc in enumerate(self._rects) if rc[5] != 0]
        if tri_in_bvh or (rect_in_bvh and rect_quad_ids):
            pv0, pv1, pv2, pcodes = [], [], [], []
            puv0, puv1, puv2, pmats = [], [], [], []
            if tri_in_bvh:
                pv0.append(np.stack(tri[0]).reshape(nt, 3))
                pv1.append(np.stack(tri[1]).reshape(nt, 3))
                pv2.append(np.stack(tri[2]).reshape(nt, 3))
                pcodes.append(np.arange(nt, dtype=np.int64) * 4 + PRIM_TRIANGLE)
                puv0.append(np.stack(tri[3]).reshape(nt, 2))
                puv1.append(np.stack(tri[4]).reshape(nt, 2))
                puv2.append(np.stack(tri[5]).reshape(nt, 2))
                pmats.append(np.asarray(tri[6], np.int64))
            if rect_in_bvh and rect_quad_ids:
                qv0, qv1, qv2, qcodes = _rect_quads(
                    self._rects, rect_quad_ids, rots, trans)
                pv0.append(qv0)
                pv1.append(qv1)
                pv2.append(qv2)
                pcodes.append(qcodes)
                # Quad rows carry zero uv / mat: their record is recomputed
                # from the rect, and the full fold masks on winner kind.
                nq = qcodes.shape[0]
                for lst in (puv0, puv1, puv2):
                    lst.append(np.zeros((nq, 2)))
                pmats.append(np.zeros((nq,), np.int64))
            v0, v1, v2 = (np.concatenate(x) for x in (pv0, pv1, pv2))
            tree = bvh_lib.build(*bvh_lib.triangle_bounds(v0, v1, v2),
                                 leaf_size=bvh_leaf_size)
            packed_nodes, packed_rows = bvh_kernel.pack_planar(
                tree, v0, v1, v2, np.concatenate(pcodes),
                uv0=np.concatenate(puv0), uv1=np.concatenate(puv1),
                uv2=np.concatenate(puv2), mats=np.concatenate(pmats))
            bvh_arrays.update(
                bvh_node_min=f(tree.node_min, tree.node_min.shape),
                bvh_node_max=f(tree.node_max, tree.node_max.shape),
                bvh_escape=dev(tree.escape),
                bvh_leaf_first=dev(tree.leaf_first),
                bvh_leaf_count=dev(tree.leaf_count),
                bvh_prim_order=dev(tree.prim_order),
                bvh_packed_nodes=dev(packed_nodes),
                bvh_packed_tris=dev(packed_rows))
            n_bvh = tree.num_nodes
        if rect_in_bvh and rect_native_ids:
            ids = np.asarray(rect_native_ids, np.int64)
            r_axis = np.asarray([self._rects[i][0] for i in ids], np.int64)
            r_k = np.asarray([self._rects[i][1] for i in ids], np.float64)
            r_lo = np.stack([self._rects[i][2] for i in ids])
            r_hi = np.stack([self._rects[i][3] for i in ids])
            tree_r = bvh_lib.build(
                *bvh_lib.rect_bounds(r_axis, r_k, r_lo, r_hi),
                leaf_size=bvh_leaf_size)
            rect_nodes, rect_rows = bvh_kernel.pack_rects(
                tree_r, r_axis, r_k, r_lo, r_hi, ids * 4 + PRIM_RECT)
            bvh_arrays.update(rect_bvh_nodes=dev(rect_nodes),
                              rect_bvh_rows=dev(rect_rows))
            n_rect_bvh = tree_r.num_nodes
        if sph_in_bvh:
            c0 = np.stack(sph[0]).reshape(ns, 3)
            c1 = np.stack(sph[1]).reshape(ns, 3)
            t0s = np.asarray(sph[2], np.float64)
            t1s = np.asarray(sph[3], np.float64)
            rr = np.asarray(sph[4], np.float64)
            xfi = np.asarray(sph[6], np.int64)
            c0w = np.einsum("nij,nj->ni", rots[xfi], c0) + trans[xfi]
            c1w = np.einsum("nij,nj->ni", rots[xfi], c1) + trans[xfi]
            tree_s = bvh_lib.build(
                *bvh_lib.sphere_bounds(c0w, c1w, rr, t0s, t1s),
                leaf_size=bvh_leaf_size)
            sph_nodes, sph_rows = bvh_kernel.pack_spheres(
                tree_s, c0w, c1w, t0s, t1s, rr,
                mats=np.asarray(sph[5], np.int64),
                has_uv=np.asarray(sph[7], np.float64))
            bvh_arrays.update(sph_bvh_nodes=dev(sph_nodes),
                              sph_bvh_rows=dev(sph_rows))
            n_sph_bvh = tree_s.num_nodes

        return SceneData(
            sph_c0=f(sph[0], (ns, 3)), sph_c1=f(sph[1], (ns, 3)),
            sph_t0=f(sph[2], (ns,)), sph_t1=f(sph[3], (ns,)),
            sph_r=f(sph[4], (ns,)), sph_mat=i32(sph[5], (ns,)),
            sph_xf=i32(sph[6], (ns,)), sph_has_uv=f(sph[7], (ns,)),
            rect_axis=i32(rect[0], (nr,)), rect_k=f(rect[1], (nr,)),
            rect_lo=f(rect[2], (nr, 2)), rect_hi=f(rect[3], (nr, 2)),
            rect_mat=i32(rect[4], (nr,)), rect_xf=i32(rect[5], (nr,)),
            tri_v0=f(tri[0], (nt, 3)), tri_v1=f(tri[1], (nt, 3)),
            tri_v2=f(tri[2], (nt, 3)),
            tri_uv0=f(tri[3], (nt, 2)), tri_uv1=f(tri[4], (nt, 2)),
            tri_uv2=f(tri[5], (nt, 2)),
            tri_mat=i32(tri[6], (nt,)), tri_xf=i32(tri[7], (nt,)),
            med_kind=i32(med[0], (nm,)), med_a=f(med[1], (nm, 3)),
            med_b=f(med[2], (nm, 3)), med_neg_inv_density=f(med[3], (nm,)),
            med_mat=i32(med[4], (nm,)), med_xf=i32(med[5], (nm,)),
            xf_rot=f(rots, rots.shape), xf_trans=f(trans, trans.shape),
            mat_kind=i32(mats[0], (-1,)), mat_tex=i32(mats[1], (-1,)),
            mat_fuzz=f(mats[2], (-1,)), mat_ir=f(mats[3], (-1,)),
            tex_kind=i32(texs[0], (-1,)),
            tex_ca=f(texs[1], (len(self._textures), 3)),
            tex_cb=f(texs[2], (len(self._textures), 3)),
            tex_cc=f(texs[3], (len(self._textures), 3)),
            tex_scale=f(texs[4], (-1,)), tex_aux=i32(texs[5], (-1,)),
            atlas=f(atlas, atlas.shape),
            img_off=i32(offs, (-1,)),
            img_w=i32(ws, (-1,)), img_h=i32(hs, (-1,)),
            per_ranvec=f(ranvec, ranvec.shape),
            per_perm=i32(perm, perm.shape),
            background=f(self.background, (3,)),
            **bvh_arrays,
            n_spheres=ns, n_rects=nr, n_triangles=nt, n_media=nm,
            n_bvh_nodes=n_bvh, n_rect_bvh_nodes=n_rect_bvh,
            n_sph_bvh_nodes=n_sph_bvh,
            tri_in_bvh=tri_in_bvh, rect_in_bvh=rect_in_bvh,
            sph_in_bvh=sph_in_bvh,
            sph_fold_safe=ns == 0 or all(
                int(xf) == 0
                or self._textures[self._materials[int(m)][1]][0]
                not in (TEX_IMAGE, TEX_BARYCENTRIC)
                for xf, m in zip(sph[6], sph[5])),
            bvh_leaf_size=bvh_leaf_size,
            mat_kinds=tuple(sorted({m[0] for m in self._materials})),
            tex_kinds=tuple(sorted({t[0] for t in self._textures})),
            has_motion=ns > 0 and not np.array_equal(
                np.asarray(sph[0]), np.asarray(sph[1])),
        )
