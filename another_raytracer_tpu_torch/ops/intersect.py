"""Vectorised closest hit over the flat SoA scene, sweep path (port of
``another_raytracer_tpu.ops.intersect``, the part the lockstep
differentiable integrator runs).

Every primitive of a kind is tested against the whole ray batch as ``[B, N]``
tensor arithmetic; the winner (t, kind, index) per ray is found with cheap
arithmetic only, and the full hit record (point, normal, UV, material) is
then recomputed for the winning primitive alone, differentiably, so
gradients reach geometry parameters through the hit point.  The winner
search itself is a detached decision: callers run ``closest_hit`` under
``torch.no_grad()``.

Behavioural contracts (reference locations): sphere half-b quadratic with
the nearest root in (t_min, t_max) and UV from the object-space outward
normal (sphere.h:24-65), moving sphere centre lerped by ray time
(moving_sphere.h:29-31), rect plane solve with inclusive bounds
(aarect.cpp), instancing through the primitive's world-from-object
transform (hittable.cpp).

Every division and sqrt whose lane may be masked out has a safe operand, as
in the JAX package: ``torch.where`` passes a zero cotangent to the branch it
did not pick, and zero times an infinite local derivative is NaN.

Not ported here: triangles (ROADMAP M16), media (M15) and BVH traversal
(M16) raise NotImplementedError; the JAX package's TPU-only knobs
(``FOLD_*``, ``RECORD_T_UNPACK``, ``TRI_PACKED_RECORD``, the one-hot
``Lookup`` gathers) are left out (M21): a plain index gathers exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from another_raytracer_tpu_torch.models import scene as scene_lib
from another_raytracer_tpu_torch.ops import vec3
from another_raytracer_tpu_torch.ops.vec3 import V3

BIG = 3e37  # effectively +infinity for t comparisons


class HitRecord(NamedTuple):
    t: torch.Tensor  # [B]
    p: V3  # world-space hit point
    normal: V3  # unit, faced toward the incoming ray
    front_face: torch.Tensor  # [B] bool
    mat: torch.Tensor  # [B] int64 material id
    u: torch.Tensor  # [B] raw surface parameter
    v: torch.Tensor  # [B]
    tu: torch.Tensor  # [B] texture coordinate
    tv: torch.Tensor  # [B]


def check_supported(scene):
    """Raise NotImplementedError for primitive kinds the port's sweep path
    does not intersect yet."""
    if scene.has_accel:
        raise NotImplementedError(
            "BVH scenes are not ported yet (ROADMAP M16)")
    if scene.n_triangles:
        raise NotImplementedError(
            "triangle intersection is not ported yet (ROADMAP M16)")
    if scene.n_media:
        raise NotImplementedError(
            "constant-density media are not ported yet (ROADMAP M15)")


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


def _ray_to_object_bn(scene, xf_ids, o: V3, d: V3):
    """World rays [B] against primitives' transforms [N] -> object rays with
    [B, N] components: o' = R^T (o - tr), d' = R^T d."""
    xf_ids = xf_ids.long()
    rot = scene.xf_rot[xf_ids]
    tr = _col3(scene.xf_trans, xf_ids)
    rt = _cols(rot)
    oc = V3(o.x[:, None] - tr.x[None, :], o.y[:, None] - tr.y[None, :],
            o.z[:, None] - tr.z[None, :])
    rtx, rty, rtz = (V3(r.x[None, :], r.y[None, :], r.z[None, :]) for r in rt)
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


# --------------------------------------------------------------------------
# Per-kind t computation.  Each returns (t [B, N], valid [B, N]).
# --------------------------------------------------------------------------


def _sphere_t(scene, o: V3, d: V3, time, t_min, t_max):
    """Quadratic sphere test against time-lerped centres (sphere.h:39-65,
    moving_sphere.h:29-58)."""
    c0 = _col3(scene.sph_c0)
    c1 = _col3(scene.sph_c1)
    t0, t1, r = scene.sph_t0, scene.sph_t1, scene.sph_r
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.sph_xf, o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)
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


def _rect_t(scene, o: V3, d: V3, t_min, t_max):
    """Axis-rect plane solve + inclusive bound check (aarect.cpp)."""
    axis, k = scene.rect_axis.long(), scene.rect_k
    lo, hi = scene.rect_lo, scene.rect_hi
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.rect_xf, o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)
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


# --------------------------------------------------------------------------
# Closest hit
# --------------------------------------------------------------------------


def _fold_kind(best, t, valid, kind):
    """Merge a [B, N] candidate set into the running (t, kind, idx) best.
    ``torch.min`` returns the first index of the minimum, which is
    ``jnp.argmin``'s tie rule."""
    bt, bk, bi = best
    t = torch.where(valid, t, torch.full_like(t, BIG))
    tm, i = torch.min(t, dim=-1)
    better = tm < bt
    return (torch.where(better, tm, bt),
            torch.where(better, torch.full_like(bk, kind), bk),
            torch.where(better, i, bi))


def closest_hit(scene, o: V3, d: V3, time, t_min):
    """Closest intersection over all primitive kinds of a sweep scene.

    Returns (t [B], kind [B] int64 with -1 = miss, idx [B] within-kind).
    Spheres fold first, so a sphere's t tightens the rects' t_max; a strict
    improvement keeps the earlier primitive on a tie.
    """
    check_supported(scene)
    z = o.x * 0.0
    best = (z + BIG, torch.full_like(z, -1, dtype=torch.int64),
            torch.zeros_like(z, dtype=torch.int64))
    if scene.n_spheres:
        t, valid = _sphere_t(scene, o, d, time, t_min, best[0][:, None])
        best = _fold_kind(best, t, valid, scene_lib.PRIM_SPHERE)
    if scene.n_rects:
        t, valid = _rect_t(scene, o, d, t_min, best[0][:, None])
        best = _fold_kind(best, t, valid, scene_lib.PRIM_RECT)
    return best


# --------------------------------------------------------------------------
# Winner hit-record reconstruction (all [B]-sized, differentiable)
# --------------------------------------------------------------------------


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
    p_obj = o_b + d_b * t
    # Outward normal in object space; /r handles the sign of negative radii.
    n_obj = (p_obj - center) * (1.0 / r)
    # Spherical UV from the detached normal: acos/atan2 have infinite pole
    # derivatives, and the UV feeds only nearest-texel lookups.
    n_uv = n_obj.map(torch.Tensor.detach)
    theta = torch.acos(torch.clamp(-n_uv.y, -1.0, 1.0))
    phi = torch.atan2(-n_uv.z, n_uv.x) + math.pi
    u = (phi / (2.0 * math.pi)) * has_uv
    v = (theta / math.pi) * has_uv
    n_world = vec3.rotate(rows, n_obj)
    p_world = o + d * t
    mat = scene.sph_mat[ii].long()
    return t, p_world, n_world, mat, u, v, u, v


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


def make_hit_record(scene, o: V3, d: V3, time, t, kind, idx) -> HitRecord:
    """Reconstruct the full hit record for each ray's winning primitive.

    ``t`` is only a detached selection hint: each kind recomputes its own t
    differentiably.  Lanes that missed get the record of kind 0's index 0;
    callers mask them out.
    """
    check_supported(scene)
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
        merge(kind == scene_lib.PRIM_SPHERE,
              _sphere_record(scene, o, d, time, t, idx))
    if scene.n_rects:
        merge(kind == scene_lib.PRIM_RECT, _rect_record(scene, o, d, t, idx))
    # set_face_normal (hittable.h:18-22).
    front = vec3.dot(d, n) < 0.0
    n = vec3.where(front, n, -n)
    return HitRecord(t=t_out, p=p, normal=n, front_face=front, mat=mat, u=u,
                     v=v, tu=tu, tv=tv)
