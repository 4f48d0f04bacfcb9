"""Vectorised closest hit over the flat SoA scene (port of
``another_raytracer_tpu.ops.intersect``).

Kinds flagged ``*_in_bvh`` on the scene resolve through the BVH closest-hit
kernel K5 (``ops/kernels/bvh_kernel.py``: the CUDA kernel on CUDA tensors,
its plain version ``ops/bvh.traverse_packed`` on CPU tensors); every other
primitive of a kind is tested against the whole ray batch as ``[B, N]``
tensor arithmetic, in chunks of ``PRIM_CHUNK`` primitives.  The winner
(t, kind, index) per ray is found with cheap arithmetic only, and the full
hit record (point, normal, UV, material) is then recomputed for the winning
primitive alone, differentiably, so gradients reach geometry parameters
through the hit point.  The winner search itself is a detached decision:
callers run ``closest_hit`` under ``torch.no_grad()``.  On the forward path
the kernel may fold the winner's record instead (``fold_tree``), and the
record then takes the folded values as they are.

Behavioural contracts (reference locations): sphere half-b quadratic with
the nearest root in (t_min, t_max) and UV from the object-space outward
normal (sphere.h:24-65), moving sphere centre lerped by ray time
(moving_sphere.h:29-31), rect plane solve with inclusive bounds
(aarect.cpp), triangle plane + edge half-plane test with area-ratio
barycentrics and a normalised normal (triangle.h:22-87; PARITY.md #3),
instancing through the primitive's world-from-object transform
(hittable.cpp), constant-density media with analytic boundaries and an
exponential free flight, one uniform per (ray, medium)
(constant_medium.h:42-80).

A sphere's hit point is re-projected onto its sphere before anything reads
it: ``p' = c + (p - c) |r| / |p - c|`` in object space, with ``c`` the
centre at the ray's time, then back through the instance transform, and the
normal is ``(p' - c) / r``.  The reference computes in double.  In float32,
a point ``o + d t`` on a sphere of radius 10-100 lying 300-600 units out
lands up to 0.05 units off the surface (the quadratic's ``c = |oc|^2 -
r^2`` cancels); from a point 4e-4 or more inside, the scattered ray meets
the sphere again past ``t_min``, its normal flips and the path bounces
inside.  On the sphere the re-projection is the identity, so gradients
keep their meaning.

Every division and sqrt whose lane may be masked out has a safe operand, as
in the JAX package: ``torch.where`` passes a zero cotangent to the branch it
did not pick, and zero times an infinite local derivative is NaN.

Left out (ROADMAP M21): the JAX package's TPU-only knobs
(``RECORD_T_UNPACK``, ``TRI_PACKED_RECORD``, the one-hot ``Lookup``
gathers): a plain index gathers exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import vec3
from another_raytracer_tpu_torch.ops.vec3 import V3

BIG = 3e37  # effectively +infinity for t comparisons
MEDIUM_REHIT_EPS = 1e-4  # reference: constant_medium.h:47 second-probe offset
SQUARE_MAX = 1e18  # a float32 component whose square sums without overflow

# Primitive chunk size of the [B, N] sweeps (the JAX package's PRIM_CHUNK):
# bounds the [B, N] temporaries; the strict fold across chunks keeps the
# first minimum, so the winner does not depend on it.
PRIM_CHUNK = 512

# The width gates of the BVH kernel's winner-record folds (``fold_tree``):
# the JAX package's values, measured on the TPU; an H100 measurement is to
# set them (ROADMAP M21).
FOLD_RECORD_MIN_B = 131072
FOLD_SPH_MIN_B = 65536


class HitRecord(NamedTuple):
    t: torch.Tensor  # [B]
    p: V3  # world-space hit point
    normal: V3  # unit, faced toward the incoming ray
    front_face: torch.Tensor  # [B] bool
    mat: torch.Tensor  # [B] int64 material id
    u: torch.Tensor  # [B] raw surface parameter (barycentric u for triangles)
    v: torch.Tensor  # [B]
    tu: torch.Tensor  # [B] texture coordinate (blended texcoord for triangles)
    tv: torch.Tensor  # [B]


def take(table, idx):
    """Rows ``idx`` of a parameter table.  ``index_select``'s backward is an
    index_add; plain indexing's backward on CUDA is serial over repeated
    indices (measured: 2.2 of 2.8 s of a lockstep step at the bench size,
    where 97,200 lanes read a 4-row texture table)."""
    return table.index_select(0, idx)


def _col3(arr2d, idx=None):
    """[N,3] table -> V3 of [N] columns (or gathered [B] columns by idx)."""
    if idx is not None:
        arr2d = take(arr2d, idx)
    return V3(arr2d[:, 0], arr2d[:, 1], arr2d[:, 2])


def _cols(rot):
    """[N,3,3] rotations -> rows of R^T (object-from-world)."""
    return (V3(rot[:, 0, 0], rot[:, 1, 0], rot[:, 2, 0]),
            V3(rot[:, 0, 1], rot[:, 1, 1], rot[:, 2, 1]),
            V3(rot[:, 0, 2], rot[:, 1, 2], rot[:, 2, 2]))


def _identity_xf(scene) -> bool:
    """Static check: the scene has only the identity transform."""
    return scene.xf_rot.shape[0] == 1


def _bcast(v: V3) -> V3:
    """[B] components -> [B,1] for broadcasting against [N] primitives."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _row(v: V3) -> V3:
    """[N] components -> [1,N]."""
    return V3(v.x[None, :], v.y[None, :], v.z[None, :])


def _ray_to_object_bn(scene, xf_ids, o: V3, d: V3):
    """World rays [B] against primitives' transforms [N] -> object rays with
    [B, N] components: o' = R^T (o - tr), d' = R^T d."""
    xf_ids = xf_ids.long()
    rot = scene.xf_rot[xf_ids]
    tr = _col3(scene.xf_trans, xf_ids)
    rt = _cols(rot)
    oc = V3(o.x[:, None] - tr.x[None, :], o.y[:, None] - tr.y[None, :],
            o.z[:, None] - tr.z[None, :])
    rtx, rty, rtz = (_row(r) for r in rt)
    o_b = V3(vec3.dot(rtx, oc), vec3.dot(rty, oc), vec3.dot(rtz, oc))
    db = _bcast(d)
    d_b = V3(vec3.dot(rtx, db), vec3.dot(rty, db), vec3.dot(rtz, db))
    return o_b, d_b


def _ray_to_object_gathered(scene, xf_ids, o: V3, d: V3):
    """Per-ray gathered transforms ([B]): (o_obj, d_obj, rows of R), the
    rows being object->world for normals."""
    xf_ids = xf_ids.long()
    r = take(scene.xf_rot, xf_ids)  # [B,3,3]
    rows = tuple(V3(r[:, i, 0], r[:, i, 1], r[:, i, 2]) for i in range(3))
    cols = tuple(V3(r[:, 0, j], r[:, 1, j], r[:, 2, j]) for j in range(3))
    tr = _col3(scene.xf_trans, xf_ids)
    oc = o - tr
    o_b = V3(vec3.dot(cols[0], oc), vec3.dot(cols[1], oc), vec3.dot(cols[2], oc))
    d_b = V3(vec3.dot(cols[0], d), vec3.dot(cols[1], d), vec3.dot(cols[2], d))
    return o_b, d_b, rows


def _object_rays_bn(scene, xf_ids, o, d):
    if not _identity_xf(scene):
        return _ray_to_object_bn(scene, xf_ids, o, d)
    return _bcast(o), _bcast(d)


# --------------------------------------------------------------------------
# Per-kind t computation over a slice of primitives.  Each returns
# (t [B, N], valid [B, N]).
# --------------------------------------------------------------------------


def _sphere_t(scene, sl, o: V3, d: V3, time, t_min, t_max):
    """Quadratic sphere test against time-lerped centres (sphere.h:39-65,
    moving_sphere.h:29-58)."""
    c0 = _col3(scene.sph_c0[sl])
    c1 = _col3(scene.sph_c1[sl])
    t0, t1, r = scene.sph_t0[sl], scene.sph_t1[sl], scene.sph_r[sl]
    o_b, d_b = _object_rays_bn(scene, scene.sph_xf[sl], o, d)
    frac = (time[:, None] - t0[None, :]) / (t1 - t0)[None, :]
    cdel = c1 - c0
    center = V3(c0.x[None, :] + frac * cdel.x[None, :],
                c0.y[None, :] + frac * cdel.y[None, :],
                c0.z[None, :] + frac * cdel.z[None, :])
    oc = o_b - center
    a = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    c = vec3.length_squared(oc) - (r * r)[None, :]
    disc = half_b * half_b - a * c
    hit_disc = disc > 0.0
    sqrtd = vec3.sqrt(torch.where(hit_disc, disc, torch.ones_like(disc)))
    root1 = (-half_b - sqrtd) / a
    root2 = (-half_b + sqrtd) / a
    r1_ok = (root1 > t_min) & (root1 < t_max)
    root = torch.where(r1_ok, root1, root2)
    valid = hit_disc & (root > t_min) & (root < t_max)
    return root, valid


def _axis_component(v: V3, axis):
    """Per-primitive axis component: axis in {0,1,2}, broadcast against v."""
    return torch.where(axis == 0, v.x, torch.where(axis == 1, v.y, v.z))


def _rect_t(scene, sl, o: V3, d: V3, t_min, t_max):
    """Axis-rect plane solve + inclusive bound check (aarect.cpp)."""
    axis, k = scene.rect_axis[sl].long(), scene.rect_k[sl]
    lo, hi = scene.rect_lo[sl], scene.rect_hi[sl]
    o_b, d_b = _object_rays_bn(scene, scene.rect_xf[sl], o, d)
    ax = axis[None, :]
    o_ax = _axis_component(o_b, ax)
    d_ax = _axis_component(d_b, ax)
    parallel = d_ax == 0.0
    t = torch.where(parallel, torch.full_like(d_ax, BIG),
                    (k[None, :] - o_ax)
                    / torch.where(parallel, torch.ones_like(d_ax), d_ax))
    # Free axes in ascending order: axis 0 -> (1,2), 1 -> (0,2), 2 -> (0,1).
    au = torch.where(ax == 0, 1, 0)
    av = torch.where(ax == 2, 1, 2)
    pu = _axis_component(o_b, au) + t * _axis_component(d_b, au)
    pv = _axis_component(o_b, av) + t * _axis_component(d_b, av)
    inside = ((pu >= lo[None, :, 0]) & (pu <= hi[None, :, 0])
              & (pv >= lo[None, :, 1]) & (pv <= hi[None, :, 1]))
    valid = inside & (t > t_min) & (t < t_max) & ~parallel
    return t, valid


def _triangle_t(scene, sl, o: V3, d: V3, t_min, t_max):
    """Scratchapixel-style plane + edge half-plane test (triangle.h:22-87).
    Returns t only; barycentrics are recomputed for the winner."""
    v0 = _col3(scene.tri_v0[sl])
    v1 = _col3(scene.tri_v1[sl])
    v2 = _col3(scene.tri_v2[sl])
    o_b, d_b = _object_rays_bn(scene, scene.tri_xf[sl], o, d)
    n = vec3.cross(v1 - v0, v2 - v0)  # [N] components
    n_row = _row(n)
    ndotd = vec3.dot(n_row, d_b)
    ndoto = vec3.dot(n_row, o_b)
    parallel = ndotd == 0.0
    t = torch.where(parallel, torch.full_like(ndotd, BIG),
                    (vec3.dot(n, v0)[None, :] - ndoto)
                    / torch.where(parallel, torch.ones_like(ndotd), ndotd))
    p = o_b + d_b * t
    w0 = vec3.dot(n_row, vec3.cross(_row(v1 - v0), p - _row(v0)))
    w1 = vec3.dot(n_row, vec3.cross(_row(v2 - v1), p - _row(v1)))
    w2 = vec3.dot(n_row, vec3.cross(_row(v0 - v2), p - _row(v2)))
    valid = ((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & (t > t_min)
             & (t < t_max) & ~parallel)
    return t, valid


def _maximum(x, c):
    """``jnp.maximum(x, c)`` for a Python float ``c``: ``torch.maximum``
    splits the gradient evenly at a tie, as JAX does (``clamp`` would pass
    all of it to ``x``).  The constant is a fill on ``x``'s device, not a
    copy from the host, so a CUDA graph can capture it."""
    return torch.maximum(x, torch.full((), c, dtype=x.dtype,
                                       device=x.device))


def _medium_interval(scene, o: V3, d: V3):
    """Boundary entry / exit interval (t1, t2, boundary_hit) of every
    medium, [B, Nm] each: the analytic equivalent of the reference's two
    hittable::hit probes (constant_medium.h:42-47), in the medium's object
    space."""
    kind = scene.med_kind
    a3 = _col3(scene.med_a)
    b3 = _col3(scene.med_b)
    o_b, d_b = _object_rays_bn(scene, scene.med_xf, o, d)

    # Sphere boundary: both quadratic roots.
    oc = V3(o_b.x - a3.x[None, :], o_b.y - a3.y[None, :],
            o_b.z - a3.z[None, :])
    qa = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    qc = vec3.length_squared(oc) - (b3.x * b3.x)[None, :]
    disc = half_b * half_b - qa * qc
    s_ok = disc > 0.0
    sq = vec3.sqrt(torch.where(s_ok, disc, torch.ones_like(disc)))
    s_t1 = (-half_b - sq) / qa
    s_t2 = (-half_b + sq) / qa

    # Box boundary: the slab interval.  The signed-epsilon divide guard
    # keeps lanes and cotangents finite for axis-parallel rays.
    def slab(dc, oc_, lo, hi):
        eps = torch.where(dc < 0, -1e-20, 1e-20)
        inv = 1.0 / torch.where(dc.abs() < 1e-20, eps, dc)
        t_a = (lo[None, :] - oc_) * inv
        t_b = (hi[None, :] - oc_) * inv
        return torch.minimum(t_a, t_b), torch.maximum(t_a, t_b)

    nx, xx = slab(d_b.x, o_b.x, a3.x, b3.x)
    ny, xy = slab(d_b.y, o_b.y, a3.y, b3.y)
    nz, xz = slab(d_b.z, o_b.z, a3.z, b3.z)
    b_t1 = torch.maximum(torch.maximum(nx, ny), nz)
    b_t2 = torch.minimum(torch.minimum(xx, xy), xz)

    is_sphere = (kind == scene_lib.MED_SPHERE)[None, :]
    t1 = torch.where(is_sphere, s_t1, b_t1)
    t2 = torch.where(is_sphere, s_t2, b_t2)
    ok = torch.where(is_sphere, s_ok, b_t1 < b_t2)
    # The reference's second probe starts at t1 + 1e-4; a thinner slab than
    # that fails its second hit.
    return t1, t2, ok & (t2 > t1 + MEDIUM_REHIT_EPS)


def _medium_t(scene, o: V3, d: V3, u_media, t_min, t_max):
    """Exponential free flight inside the boundary (constant_medium.h:49-80)
    for [B, Nm] uniforms ``u_media``.  log(0) = -inf gives an infinite
    distance, rejected, as the reference when random_double() returns 0."""
    t1, t2, ok = _medium_interval(scene, o, d)
    r1 = _maximum(t1, t_min)
    r2 = torch.minimum(t2, t_max)
    ok = ok & (r1 < r2)
    r1 = _maximum(r1, 0.0)
    ray_len = vec3.length(d)[:, None]
    dist_inside = (r2 - r1) * ray_len
    hit_dist = scene.med_neg_inv_density[None, :] * vec3.log(u_media)
    ok = ok & (hit_dist <= dist_inside)
    return r1 + hit_dist / ray_len, ok


# --------------------------------------------------------------------------
# Closest hit
# --------------------------------------------------------------------------


def _fold_kind(best, t, valid, kind, base_idx=0):
    """Merge a [B, N] candidate set into the running (t, kind, idx) best.
    ``torch.min`` returns the first index of the minimum, which is
    ``jnp.argmin``'s tie rule."""
    bt, bk, bi = best
    t = torch.where(valid, t, torch.full_like(t, BIG))
    tm, i = torch.min(t, dim=-1)
    better = tm < bt
    return (torch.where(better, tm, bt),
            torch.where(better, torch.full_like(bk, kind), bk),
            torch.where(better, i + base_idx, bi))


def _scan_kind(best, n_total, chunk_fn, kind):
    """Fold a whole primitive kind, chunk by chunk.  Every chunk's test takes
    the best t on entry to the kind as its t_max, as the JAX package's
    chunks do; the strict fold makes the winner the same either way."""
    t_max = best[0][:, None]
    for start in range(0, n_total, PRIM_CHUNK):
        sl = slice(start, min(start + PRIM_CHUNK, n_total))
        t, valid = chunk_fn(sl, t_max)
        best = _fold_kind(best, t, valid, kind, start)
    return best


def fold_tree(scene, width):
    """The tree whose winner record K5 folds on the forward wavefront at
    ``width`` lanes, the one statement of when it does (the JAX package's
    gates, intersect.py:351-394 there): 'planar' where the scene's
    triangles are in the planar tree, from ``FOLD_RECORD_MIN_B`` lanes; else
    'sphere' where the spheres are in a tree, no planar tree claims the one
    record slot and every sphere's world normal is its UV's normal
    (``scene.sph_fold_safe``), from ``FOLD_SPH_MIN_B`` lanes; else None.
    The planar fold gives the winning triangle's unit normal, barycentrics,
    texcoords and material, the sphere fold the world centre at the ray's
    time, the radius, material and has_uv: the record needs no winner
    gather."""
    if scene.tri_in_bvh and width >= FOLD_RECORD_MIN_B:
        return "planar"
    if (scene.sph_in_bvh and scene.n_bvh_nodes == 0 and scene.sph_fold_safe
            and width >= FOLD_SPH_MIN_B):
        return "sphere"
    return None


def k5_variant(prim, fold):
    """K5's (fold_record, fold_full, precomp) on the ``prim`` tree where the
    wavefront folds ``fold``'s record (``fold_tree``): the planar tree is
    walked on its precomputed leaf-test geometry and folds the full record
    (with texcoords and material)."""
    record, planar = fold == prim, prim == "planar"
    return record, record and planar, planar


def _fold_bvh(scene, best, nodes, rows, o, d, time, t_min, prim, fold=None):
    """Fold one packed BVH's winner into the running best through K5, in
    ``k5_variant(prim, fold)``.  The traversal returns rows' codes (id*4 +
    kind) for improved lanes and copies the init value through otherwise,
    so the decode is gated on improved.

    Where ``fold`` is ``prim``, also return the kernel-folded winner record,
    tagged with its tree kind: ('planar', n, u, v, tu, tv, mat) or
    ('sphere', centre, r, mat, has_uv), valid wherever the final winner kind
    is that tree's (later folds only override on strict improvement)."""
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    bt, bk, bi = best
    record, full, pre = k5_variant(prim, fold)
    out = bvh_kernel.bvh_closest_hit(
        nodes, rows, o, d, bt, bi.to(torch.int32), t_min=float(t_min),
        leaf_size=scene.bvh_leaf_size, prim=prim, time=time,
        fold_record=record, fold_full=full, precomp=pre,
        tables=scene.k5_tables(prim, pre))
    t, code, improved = out[:3]
    code = code.long()
    kind = torch.where(improved, code % 4, bk)
    idx = torch.where(improved, code // 4, bi)
    if record:
        return (t, kind, idx), (prim,) + tuple(out[3:])
    return (t, kind, idx)


def closest_hit(scene, o: V3, d: V3, time, u_media, t_min, fold=None):
    """Closest intersection over all primitive kinds.

    Returns (t [B], kind [B] int64 with -1 = miss, idx [B] within-kind), and
    with ``fold`` ('planar' or 'sphere', ``fold_tree``'s answer) as
    ((t, kind, idx), the kernel-folded winner record of that tree; see
    ``_fold_bvh``).  BVH folds run first, so their winner t tightens the
    sweeps' t_max; then the sweeps of spheres, rects and triangles outside
    a BVH, and last the media's free flights (``u_media``: [B, Nm]
    uniforms, ``integrator.media_uniforms``).  A strict improvement keeps
    the earlier primitive on a tie.
    """
    z = o.x * 0.0
    best = (z + BIG, torch.full_like(z, -1, dtype=torch.int64),
            torch.zeros_like(z, dtype=torch.int64))
    aux = None
    if scene.n_bvh_nodes:  # planar tree: triangles and/or transformed rects
        best = _fold_bvh(scene, best, scene.bvh_packed_nodes,
                         scene.bvh_packed_tris, o, d, time, t_min, "planar",
                         fold)
        if fold == "planar":
            best, aux = best
    if scene.n_rect_bvh_nodes:  # native axis-rect tree (identity transforms)
        best = _fold_bvh(scene, best, scene.rect_bvh_nodes,
                         scene.rect_bvh_rows, o, d, time, t_min, "rect")
    if scene.n_sph_bvh_nodes:
        best = _fold_bvh(scene, best, scene.sph_bvh_nodes, scene.sph_bvh_rows,
                         o, d, time, t_min, "sphere", fold)
        if fold == "sphere":
            best, aux = best
    if scene.n_spheres and not scene.sph_in_bvh:
        best = _scan_kind(
            best, scene.n_spheres,
            lambda sl, t_max: _sphere_t(scene, sl, o, d, time, t_min, t_max),
            scene_lib.PRIM_SPHERE)
    if scene.n_rects and not scene.rect_in_bvh:
        best = _scan_kind(
            best, scene.n_rects,
            lambda sl, t_max: _rect_t(scene, sl, o, d, t_min, t_max),
            scene_lib.PRIM_RECT)
    if scene.n_triangles and not scene.tri_in_bvh:
        best = _scan_kind(
            best, scene.n_triangles,
            lambda sl, t_max: _triangle_t(scene, sl, o, d, t_min, t_max),
            scene_lib.PRIM_TRIANGLE)
    if scene.n_media:
        t, valid = _medium_t(scene, o, d, u_media, t_min, best[0][:, None])
        best = _fold_kind(best, t, valid, scene_lib.PRIM_MEDIUM)
    if fold:
        return best, aux
    return best


# --------------------------------------------------------------------------
# Winner hit-record reconstruction (all [B]-sized, differentiable)
# --------------------------------------------------------------------------


def _sphere_uv(n_obj: V3, has_uv):
    """Spherical UV from the detached object-space outward normal
    (sphere.h:24-37): acos / atan2 have infinite pole derivatives, and the
    UV feeds only nearest-texel lookups."""
    n_uv = n_obj.map(torch.Tensor.detach)
    theta = torch.acos(torch.clamp(-n_uv.y, -1.0, 1.0))
    phi = torch.atan2(-n_uv.z, n_uv.x) + math.pi
    return (phi / (2.0 * math.pi)) * has_uv, (theta / math.pi) * has_uv


def _sphere_record(scene, o, d, time, t, idx):
    ii = torch.clamp(idx, 0, scene.n_spheres - 1)
    c0 = _col3(scene.sph_c0, ii)
    c1 = _col3(scene.sph_c1, ii)
    t0, t1, r = (take(x, ii) for x in (scene.sph_t0, scene.sph_t1, scene.sph_r))
    has_uv = take(scene.sph_has_uv, ii)
    o_b, d_b, rows = _ray_to_object_gathered(scene, scene.sph_xf[ii], o, d)
    frac = (time - t0) / (t1 - t0)
    center = c0 + (c1 - c0) * frac
    # Differentiable t recompute: which root won is a detached decision, the
    # root's value a smooth function of the sphere's parameters.
    oc = o_b - center
    a = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    c = vec3.length_squared(oc) - r * r
    disc = half_b * half_b - a * c
    sq = vec3.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    pick1 = (root1 - t).abs() <= (root2 - t).abs()
    t = torch.where(disc > 0, torch.where(pick1, root1, root2), t)
    off = o_b + d_b * t - center
    on = _onto_sphere(off, r)
    # Outward normal in object space; /r handles the sign of negative radii.
    n_obj = on * (1.0 / r)
    u, v = _sphere_uv(n_obj, has_uv)
    n_world = vec3.rotate(rows, n_obj)
    if _identity_xf(scene):
        # Object space is world space: the point moves by the step alone
        # (none where it lies on the sphere already).
        p_world = o + d * t + (on - off)
    else:
        # Back through the instance transform: the world point o + d t and
        # the object point differ by the transform's rounding.
        p_world = (vec3.rotate(rows, center + on)
                   + _col3(scene.xf_trans, scene.sph_xf[ii].long()))
    mat = scene.sph_mat[ii].long()
    return t, p_world, n_world, mat, u, v, u, v


def _onto_sphere(off: V3, r):
    """The offset ``p - c`` of a hit point from its sphere's centre,
    rescaled to the radius ``|r|`` (the re-projection of the module's
    contracts).  A lane whose offset is zero or too long to square (a
    masked lane's t of ``BIG``) keeps it; the square is taken of a safe
    stand-in there, so no cotangent meets an infinity."""
    fits = ((off.x.abs() < SQUARE_MAX) & (off.y.abs() < SQUARE_MAX)
            & (off.z.abs() < SQUARE_MAX))
    one = torch.ones_like(off.x)
    safe = vec3.where(fits, off, V3(one, one, one))
    len2 = vec3.length_squared(safe)
    ok = fits & (len2 > 0.0)
    scale = r.abs() / vec3.sqrt(torch.where(ok, len2, one))
    return vec3.where(ok, safe * scale, off)


def _sphere_record_aux(scene, o, d, t, aux):
    """Forward-path sphere record from the kernel-folded winner (its world
    centre at the ray's time and radius, as K5 tested them, its mat id and
    has_uv): no winner gather.  Identity-safe spheres only (``fold_tree``):
    the world normal is the object-space normal the UV needs.
    t is the kernel's winner t, used as it is."""
    center, r, mat_f, has_uv = aux
    mat = torch.clamp(mat_f.long(), 0, scene.mat_kind.shape[0] - 1)
    p = o + d * t
    off = p - center
    on = _onto_sphere(off, r)
    n_world = on * (1.0 / r)
    u, v = _sphere_uv(n_world, has_uv)
    return t, p + (on - off), n_world, mat, u, v, u, v


def _rect_record(scene, o, d, t, idx):
    ii = torch.clamp(idx, 0, scene.n_rects - 1)
    axis, k = scene.rect_axis[ii].long(), take(scene.rect_k, ii)
    lo, hi = take(scene.rect_lo, ii), take(scene.rect_hi, ii)
    lo0, lo1, hi0, hi1 = lo[:, 0], lo[:, 1], hi[:, 0], hi[:, 1]
    o_b, d_b, rows = _ray_to_object_gathered(scene, scene.rect_xf[ii], o, d)
    # Differentiable t recompute from the plane equation.
    o_ax = _axis_component(o_b, axis)
    d_ax = _axis_component(d_b, axis)
    ok = d_ax != 0.0
    t = torch.where(ok, (k - o_ax) / torch.where(ok, d_ax, torch.ones_like(d_ax)), t)
    p_obj = o_b + d_b * t
    au = torch.where(axis == 0, 1, 0)
    av = torch.where(axis == 2, 1, 2)
    pu = _axis_component(p_obj, au)
    pv = _axis_component(p_obj, av)
    u = (pu - lo0) / (hi0 - lo0)
    v = (pv - lo1) / (hi1 - lo1)
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    n_obj = V3(torch.where(axis == 0, one, zero), torch.where(axis == 1, one, zero),
               torch.where(axis == 2, one, zero))
    n_world = vec3.rotate(rows, n_obj)
    p_world = o + d * t
    return t, p_world, n_world, scene.rect_mat[ii].long(), u, v, u, v


def _triangle_record(scene, o, d, t, idx):
    ii = torch.clamp(idx, 0, scene.n_triangles - 1)
    v0, v1, v2 = (_col3(x, ii) for x in (scene.tri_v0, scene.tri_v1,
                                          scene.tri_v2))
    if _identity_xf(scene):
        # The identity rotation's products are exact, so this equals the
        # gathered transform's result.
        o_b, d_b, rows = o, d, None
    else:
        o_b, d_b, rows = _ray_to_object_gathered(scene, scene.tri_xf[ii], o, d)
    n = vec3.cross(v1 - v0, v2 - v0)
    # Differentiable t recompute from the plane equation.
    ndotd = vec3.dot(n, d_b)
    ok = ndotd != 0.0
    t = torch.where(ok, (vec3.dot(n, v0) - vec3.dot(n, o_b))
                    / torch.where(ok, ndotd, torch.ones_like(ndotd)), t)
    p_obj = o_b + d_b * t
    n2 = vec3.length_squared(n)
    # Area-ratio barycentrics exactly as triangle.h:62-84: u weights vertex 1,
    # v weights vertex 2, (1-u-v) weights vertex 3.
    u = vec3.dot(n, vec3.cross(v2 - v1, p_obj - v1)) / n2
    v = vec3.dot(n, vec3.cross(v0 - v2, p_obj - v2)) / n2
    w = 1.0 - u - v
    uv0, uv1, uv2 = (take(x, ii) for x in (scene.tri_uv0, scene.tri_uv1,
                                           scene.tri_uv2))
    tu = u * uv0[:, 0] + v * uv1[:, 0] + w * uv2[:, 0]
    tv = u * uv0[:, 1] + v * uv1[:, 1] + w * uv2[:, 1]
    # Normalised normal: a divergence from the reference (PARITY.md #3).
    n_world = vec3.unit(n if rows is None else vec3.rotate(rows, n))
    p_world = o + d * t
    return t, p_world, n_world, scene.tri_mat[ii].long(), u, v, tu, tv


def _triangle_record_aux(scene, o, d, t, aux):
    """Forward-path triangle record from the kernel-folded aux (n, u, v, tu,
    tv, mat): no winner gather.  t is the kernel's winner t, used as it is
    (the differentiable path never comes here)."""
    n_aux, u, v, tu, tv, mat_f = aux
    # Garbage on non-triangle winners (masked by kind in make_hit_record);
    # clamped so the material gathers stay in range.
    mat = torch.clamp(mat_f.long(), 0, scene.mat_kind.shape[0] - 1)
    return t, o + d * t, n_aux, mat, u, v, tu, tv


def _medium_record(scene, o, d, t, idx, u_media, t_min):
    ii = torch.clamp(idx, 0, scene.n_media - 1)
    # Differentiable t recompute: given the (detached) uniform, the free
    # flight is a smooth function of the boundary interval and the density.
    t1, _, _ = _medium_interval(scene, o, d)
    if scene.n_media == 1:
        t1, u = t1[:, 0], u_media[:, 0]
    else:
        sel = ii[:, None] == torch.arange(scene.n_media, device=ii.device)
        t1 = torch.where(sel, t1, torch.zeros_like(t1)).sum(dim=1)
        u = torch.where(sel, u_media, torch.zeros_like(u_media)).sum(dim=1)
    r1 = _maximum(_maximum(t1, t_min), 0.0)
    hd = take(scene.med_neg_inv_density, ii) * vec3.log(_maximum(u, 1e-37))
    t = r1 + hd / vec3.length(d)
    # Arbitrary fixed normal, front face (constant_medium.h:77-78).
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    return (t, o + d * t, V3(one, zero, zero), scene.med_mat[ii].long(),
            zero, zero, zero, zero)


def make_hit_record(scene, o: V3, d: V3, time, t, kind, idx, u_media=None,
                    t_min=1e-3, aux=None) -> HitRecord:
    """Reconstruct the full hit record for each ray's winning primitive.

    ``t`` is only a detached selection hint: each kind recomputes its own t
    differentiably.  ``u_media`` (needed where the scene has media) and
    ``t_min`` must be those of the winner selection: the medium recompute redraws its free flight from the same
    uniform and clamps the boundary entry to ``t_min``
    (constant_medium.h:57).  ``aux``: the kernel-folded winner record from
    ``closest_hit(fold=...)`` (forward path only), which replaces its
    tree kind's recompute.  Lanes that missed get some kind's record of
    index 0; callers mask them out.
    """
    z = torch.zeros_like(o.x)
    zv = V3(z, z, z)
    t_out, p, n = t, zv, zv
    mat = torch.zeros(t.shape, dtype=torch.int64, device=t.device)
    u = v = tu = tv = z

    def merge(cond, new):
        nonlocal t_out, p, n, mat, u, v, tu, tv
        nt, np_, nn, nm, nu, nv, ntu, ntv = new
        t_out = torch.where(cond, nt, t_out)
        p = vec3.where(cond, np_, p)
        n = vec3.where(cond, nn, n)
        mat = torch.where(cond, nm, mat)
        u = torch.where(cond, nu, u)
        v = torch.where(cond, nv, v)
        tu = torch.where(cond, ntu, tu)
        tv = torch.where(cond, ntv, tv)

    if scene.n_spheres:
        if aux is not None and aux[0] == "sphere":
            sph = _sphere_record_aux(scene, o, d, t, aux[1:])
        else:
            sph = _sphere_record(scene, o, d, time, t, idx)
        merge(kind == scene_lib.PRIM_SPHERE, sph)
    if scene.n_rects:
        merge(kind == scene_lib.PRIM_RECT, _rect_record(scene, o, d, t, idx))
    if scene.n_triangles:
        if aux is not None and aux[0] == "planar":
            tri = _triangle_record_aux(scene, o, d, t, aux[1:])
        else:
            tri = _triangle_record(scene, o, d, t, idx)
        merge(kind == scene_lib.PRIM_TRIANGLE, tri)
    if scene.n_media:
        merge(kind == scene_lib.PRIM_MEDIUM,
              _medium_record(scene, o, d, t, idx, u_media, t_min))
    # set_face_normal (hittable.h:18-22); a medium's record keeps its
    # normal and faces front.
    front = (vec3.dot(d, n) < 0.0) | (kind == scene_lib.PRIM_MEDIUM)
    n = vec3.where(front, n, -n)
    return HitRecord(t=t_out, p=p, normal=n, front_face=front, mat=mat, u=u,
                     v=v, tu=tu, tv=tv)
