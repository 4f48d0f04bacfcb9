"""The reference path tracer: *Ray Tracing in One Weekend* / *The Next
Week* semantics (no russian roulette, no light sampling), every draw keyed
by (seed, pixel, sample, bounce, lane) as ``rng`` lays them out.

A path contributes the emission of the light it hits, or the background
where it leaves the scene, times the product of the albedos on its way;
it ends there, at a light, or after ``max_depth`` casts.  Segments count
the primary rays and every scatter.  The closest hit is sequential, as a
list of hittables is walked (``closest_hit``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import rng, scene as scene_lib

NEAR_ZERO = 1e-8
MEDIUM_REHIT = 1e-4  # a medium's second boundary probe starts past this
RAY_BLOCK = 1 << 16  # rays per block of a triangle chunk's test


def camera(cam: dict, width: int, height: int) -> dict:
    """The pinhole camera of ``cam`` (lookfrom, lookat, vup, vfov,
    focus_dist) in float64 numpy."""
    if float(cam.get("aperture", 0.0)) != 0.0:
        raise ValueError("the reference traces pinhole cameras only")
    look_from = np.asarray(cam["lookfrom"], np.float64)
    w = look_from - np.asarray(cam["lookat"], np.float64)
    w /= np.linalg.norm(w)
    u = np.cross(np.asarray(cam["vup"], np.float64), w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    vh = 2.0 * math.tan(math.radians(cam["vfov"]) / 2.0)
    vw = width / height * vh
    focus = float(cam["focus_dist"])
    hor, ver = focus * vw * u, focus * vh * v
    return {"origin": look_from, "horizontal": hor, "vertical": ver,
            "corner": -hor / 2 - ver / 2 - focus * w}


def primary_rays(cam, pix, samp, seed, width, height, dtype):
    """Origins and directions [B, 3] of (pixel, sample) through the image
    plane, jittered inside the pixel."""
    dev = pix.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    ju, jv = rng.uniform2(seed, pix, samp, rng.CAMERA_BOUNCE, rng.DIM_JITTER,
                          dtype)
    s = ((pix % width).to(dtype) + ju) / (width - 1)
    r = ((height - 1) - (pix // width).to(dtype) + jv) / (height - 1)
    d = t(cam["corner"]) + s[:, None] * t(cam["horizontal"]) \
        + r[:, None] * t(cam["vertical"])
    return t(cam["origin"]).expand_as(d), d


def _rect_normals(sc):
    """World normals [Nr, 3] of the rects: the transform's column of the
    rect's fixed axis."""
    rot = sc.xf_rot.double().cpu().numpy()
    return torch.as_tensor(
        np.stack([rot[xf][:, axis] for axis, *_, xf in sc.rects]),
        dtype=sc.dtype, device=sc.device)


def closest_hit(sc, o, d, u_med, t_min):
    """(t, kind, index) of the nearest hit past ``t_min``: kind 0 a rect,
    1 a triangle, 2 a medium, -1 none.  Rects one at a time, then triangle
    chunks (each against the rays that reach its box), then media, each
    taking a hit only where it is strictly nearer than the nearest so
    far."""
    n_rays = o.shape[0]
    best = torch.full((n_rays,), math.inf, dtype=sc.dtype, device=o.device)
    kind = torch.full((n_rays,), -1, dtype=torch.int64, device=o.device)
    index = torch.zeros_like(kind)

    obj = {}
    for i, (axis, k, lo0, lo1, hi0, hi1, _mat, xf) in enumerate(sc.rects):
        if xf not in obj:
            rot, tr = sc.xf_rot[xf], sc.xf_trans[xf]
            obj[xf] = (o, d) if xf == 0 else ((o - tr) @ rot, d @ rot)
        ob, db = obj[xf]
        au, av = [a for a in (0, 1, 2) if a != axis]
        den = db[:, axis]
        t = (k - ob[:, axis]) / den
        pu = ob[:, au] + t * db[:, au]
        pv = ob[:, av] + t * db[:, av]
        ok = ((den != 0) & (t > t_min) & (t < best) & (pu >= lo0)
              & (pu <= hi0) & (pv >= lo1) & (pv <= hi1))
        best = torch.where(ok, t, best)
        kind = torch.where(ok, 0, kind)
        index = torch.where(ok, i, index)

    if sc.chunks:
        tri = sc.tri
        inv = 1.0 / d
        for start, end, lo, hi in sc.chunks:
            t0, t1 = (lo - o) * inv, (hi - o) * inv
            near = torch.fmin(t0, t1).amax(1)
            far = torch.fmax(t0, t1).amin(1)
            rays = torch.nonzero((far >= near) & (far > t_min)
                                 & (near < best)).squeeze(1)
            n, nv0 = tri["n"][start:end], tri["nv0"][start:end]
            m = tri["m"][start:end].reshape(-1, 3)
            c = tri["c"][start:end]
            for b0 in range(0, rays.shape[0], RAY_BLOCK):
                r = rays[b0:b0 + RAY_BLOCK]
                orr, drr = o[r], d[r]
                nd = drr @ n.T
                t = (nv0 - orr @ n.T) / nd
                w = ((orr @ m.T).view(len(r), -1, 3)
                     + t[..., None] * (drr @ m.T).view(len(r), -1, 3) - c)
                ok = ((nd != 0) & (t > t_min) & (t < best[r][:, None])
                      & (w >= 0).all(-1))
                tmin, j = torch.where(ok, t, math.inf).min(1)
                better = tmin < best[r]
                r = r[better]
                best[r] = tmin[better]
                kind[r] = 1
                index[r] = j[better] + start

    for q, (center, radius, neg_inv_density, _mat) in enumerate(sc.media):
        oc = o - center
        a = (d * d).sum(1)
        half_b = (oc * d).sum(1)
        disc = half_b * half_b - a * ((oc * oc).sum(1) - radius * radius)
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1, t2 = (-half_b - sq) / a, (-half_b + sq) / a
        r1 = torch.clamp_min(t1, t_min)
        r2 = torch.minimum(t2, best)
        ok = (disc > 0) & (t2 > t1 + MEDIUM_REHIT) & (r1 < r2)
        r1 = torch.clamp_min(r1, 0.0)
        length = torch.sqrt(a)
        flight = neg_inv_density * torch.log(u_med[:, q])
        t = r1 + flight / length
        ok = ok & (flight <= (r2 - r1) * length) & (t < best)
        best = torch.where(ok, t, best)
        kind = torch.where(ok, 2, kind)
        index = torch.where(ok, q, index)
    return best, kind, index


def hit_record(sc, o, d, t, kind, index, rect_normal):
    """(point, unit normal facing the ray, material, tu, tv) of rays that
    hit."""
    p = o + d * t[:, None]
    n = torch.zeros_like(o)
    mat = torch.zeros_like(kind)
    tu = torch.zeros_like(t)
    tv = torch.zeros_like(t)
    is_rect, is_tri = kind == 0, kind == 1
    if sc.rects:
        i = index[is_rect]
        n[is_rect] = rect_normal[i]
        mat[is_rect] = torch.as_tensor([r[6] for r in sc.rects],
                                       device=o.device)[i]
    if sc.chunks:
        j = index[is_tri]
        tri = sc.tri
        tn = tri["n"][j]
        n[is_tri] = tn / torch.sqrt((tn * tn).sum(1, keepdim=True))
        pw = p[is_tri]
        w = (tri["m"][j] @ pw[:, :, None])[..., 0] - tri["c"][j]
        bu, bv = w[:, 1] / tri["n2"][j], w[:, 2] / tri["n2"][j]
        uv = tri["uv"][j]
        tex = (bu[:, None] * uv[:, 0] + bv[:, None] * uv[:, 1]
               + (1.0 - bu - bv)[:, None] * uv[:, 2])
        tu[is_tri], tv[is_tri] = tex[:, 0], tex[:, 1]
        mat[is_tri] = tri["mat"][j]
    is_med = kind == 2
    if sc.media:
        n[is_med, 0] = 1.0
        mat[is_med] = torch.as_tensor([m[3] for m in sc.media],
                                      device=o.device)[index[is_med]]
    front = ((d * n).sum(1) < 0) | is_med
    n = torch.where(front[:, None], n, -n)
    return p, n, mat, tu, tv


def texture_value(sc, leaves, tex, tu, tv):
    """Albedo [B, 3] of textures ``tex`` at (tu, tv): solid colours from
    ``tex_ca``, image textures from the nearest texel of ``atlas``."""
    out = leaves["tex_ca"].index_select(0, tex)
    image = sc.tex_kind[tex] == scene_lib.IMAGE
    if bool(image.any()):
        img = sc.tex_img[tex].clamp_min(0)
        w, h = sc.img_w[img], sc.img_h[img]
        cu = torch.clamp(tu, 0.0, 1.0)
        cv = 1.0 - torch.clamp(tv, 0.0, 1.0)
        i = torch.minimum((cu * w.to(tu.dtype)).long(), w - 1)
        j = torch.minimum((cv * h.to(tv.dtype)).long(), h - 1)
        texel = leaves["atlas"].index_select(0, sc.img_off[img] + j * w + i)
        out = torch.where(image[:, None], texel, out)
    return out


def _add(acc, rows, values):
    if torch.is_grad_enabled():
        return acc.index_add(0, rows, values)
    return acc.index_add_(0, rows, values)


def trace(sc, leaves, acc, rows, o, d, pix, samp, seed, max_depth, t_min):
    """Trace paths (o, d) of (pixel, sample) = (pix, samp), adding each
    path's radiance into ``acc[rows]``.  Returns (acc, segments)."""
    dtype = sc.dtype
    rect_normal = _rect_normals(sc) if sc.rects else None
    mat_kind = torch.as_tensor(sc.mat_kind, device=o.device)
    want_ball = scene_lib.ISOTROPIC in sc.mat_kind
    thr = torch.ones_like(o)
    segments = o.shape[0]
    for bounce in range(max_depth):
        if o.shape[0] == 0:
            break
        u_med = (torch.stack([rng.uniform2(seed, pix, samp, bounce,
                                           rng.DIM_MEDIUM + 2 * q, dtype)[0]
                              for q in range(len(sc.media))], 1)
                 if sc.media else None)
        t, kind, index = closest_hit(sc, o, d, u_med, t_min)
        hit = kind >= 0
        miss = ~hit
        if bool(miss.any()):
            acc = _add(acc, rows[miss], thr[miss] * leaves["background"])
        o, d, thr, pix, samp, rows, t, kind, index = (
            x[hit] for x in (o, d, thr, pix, samp, rows, t, kind, index))
        p, n, mat, tu, tv = hit_record(sc, o, d, t, kind, index, rect_normal)
        albedo = texture_value(sc, leaves, sc.mat_tex[mat], tu, tv)
        mk = mat_kind[mat]
        light = mk == scene_lib.DIFFUSE_LIGHT
        if bool(light.any()):
            acc = _add(acc, rows[light], thr[light] * albedo[light])
        u1, u2 = rng.uniform2(seed, pix, samp, bounce, rng.DIM_SCATTER_A,
                              dtype)
        z = 1.0 - 2.0 * u1
        rad = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = (2.0 * math.pi) * u2
        unit = torch.stack((rad * torch.cos(phi), rad * torch.sin(phi), z), 1)
        new_d = n + unit
        new_d = torch.where((new_d.abs() < NEAR_ZERO).all(1, keepdim=True),
                            n, new_d)
        if want_ball:
            u3 = rng.uniform2(seed, pix, samp, bounce, rng.DIM_SCATTER_B,
                              dtype)[0]
            ball = unit * torch.pow(u3, 1.0 / 3.0)[:, None]
            new_d = torch.where((mk == scene_lib.ISOTROPIC)[:, None], ball,
                                new_d)
        keep = ~light
        thr = thr * albedo
        o, d, thr, pix, samp, rows = (
            x[keep] for x in (p, new_d, thr, pix, samp, rows))
        segments += int(keep.sum())
    return acc, segments


def radiance(sc, cam, pixels, *, width, height, spp, max_depth, seed,
             t_min=1e-3, leaves=None, lanes=1 << 22):
    """Radiance sums [N, 3] over ``spp`` samples of ``pixels`` (flat
    ``j * width + i``, int64 on the scene's device) and the segments
    traced.  ``leaves`` replaces the scene's shading leaves (a training
    step's); ``lanes`` bounds the paths traced at once."""
    leaves = sc.leaves if leaves is None else leaves
    n_pix = pixels.shape[0]
    acc = torch.zeros((n_pix, 3), dtype=sc.dtype, device=sc.device)
    segments = 0
    per = max(1, lanes // max(n_pix, 1))
    for s0 in range(0, spp, per):
        ns = min(per, spp - s0)
        lane = torch.arange(n_pix * ns, device=sc.device)
        rows = lane % n_pix
        pix, samp = pixels[rows], s0 + lane // n_pix
        o, d = primary_rays(cam, pix, samp, seed, width, height, sc.dtype)
        acc, segs = trace(sc, leaves, acc, rows, o, d, pix, samp, seed,
                          max_depth, t_min)
        segments += segs
    return acc, segments


def gamma(acc, spp):
    """Mean over the samples, gamma 2, clamped to [0, 0.999]."""
    return torch.clamp(torch.sqrt(torch.clamp_min(acc * (1.0 / spp), 0.0)),
                       0.0, 0.999)


def to_uint8(acc, spp):
    return (256.0 * gamma(acc, spp)).to(torch.uint8)


def render(sc, cam, *, width, height, spp, max_depth, seed, t_min=1e-3):
    """The whole image as uint8 [H, W, 3] (numpy) and its segments."""
    pixels = torch.arange(width * height, device=sc.device)
    with torch.no_grad():
        acc, segments = radiance(sc, cam, pixels, width=width, height=height,
                                 spp=spp, max_depth=max_depth, seed=seed,
                                 t_min=t_min)
    img = to_uint8(acc, spp).cpu().numpy().reshape(height, width, 3)
    return img, segments
