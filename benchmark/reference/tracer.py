"""The reference path tracer: *Ray Tracing in One Weekend* / *The Next
Week* semantics (no russian roulette, no light sampling), every draw keyed
by (seed, pixel, sample, bounce, lane) as ``rng`` lays them out.

A path contributes the emission of the light it hits, or the background
where it leaves the scene, times the product of the albedos on its way;
it ends there, at a light, where its material absorbs it, or after
``max_depth`` casts.  Segments count the primary rays and every scatter.
The closest hit is sequential, as a list of hittables is walked
(``closest_hit``): a primitive takes the hit only where it is strictly
nearer than the nearest so far.

Materials (``material.h``): lambertian, normal plus a random unit vector,
the normal where that is near zero; metal, the unit direction reflected
plus ``fuzz`` times a point of the unit ball, absorbed where that points
below the surface; dielectric, attenuation 1, reflected where it cannot
refract or where Schlick's reflectance beats a uniform, else refracted;
diffuse light, its texture emitted and no scatter; isotropic (a medium), a
point of the unit ball.  Textures (``texture.h``): solid; checker, the odd
colour where sin(10x) sin(10y) sin(10z) < 0; noise, 0.5 (1 + Perlin noise
at ``scale`` p); image, the nearest texel at (u, 1 - v) clamped.  A
sphere's (u, v) comes from its object-space outward normal (``sphere.h``
``get_sphere_uv``); a moving sphere's centre is lerped by the ray's time.
Media (``constant_medium.h``): the boundary's entry and exit (a sphere, or
a box by its slabs), an exponential free flight from one uniform per (ray,
medium).  The camera is the thin lens of ``camera.h``: origins on the lens
disk, a time in the shutter.

Departures, all of them the program's too: the rejection samplers are
closed-form maps of keyed uniforms (a unit vector from two, a point of the
ball from three, one of the disk from two); a moving sphere has (u, v) =
(0, 0) (``moving_sphere.h`` sets none); a hit must be strictly inside (t_min,
nearest) where the book takes the closed interval; a rect has no texture
coordinates (no scene maps an image onto one)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import perlin, rng, scene as scene_lib

NEAR_ZERO = 1e-8
MEDIUM_REHIT = 1e-4  # a medium's second boundary probe starts past this
RAY_BLOCK = 1 << 16  # rays per block of a chunk's test
MEDIUM = 3  # the closest hit's kind of a medium (after the chunk kinds)


def camera(cam: dict, width: int, height: int) -> dict:
    """The thin-lens camera of ``cam`` (lookfrom, lookat, vup, vfov,
    aperture, focus_dist, time0, time1) in float64 numpy."""
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
            "corner": -hor / 2 - ver / 2 - focus * w, "u": u, "v": v,
            "lens_radius": float(cam.get("aperture", 0.0)) / 2.0,
            "time0": float(cam.get("time0", 0.0)),
            "time1": float(cam.get("time1", 0.0))}


def primary_rays(cam, pix, samp, seed, width, height, dtype):
    """Origins and directions [B, 3] and times [B] of (pixel, sample)
    through the image plane, jittered inside the pixel."""
    dev = pix.device

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    ju, jv = rng.uniform2(seed, pix, samp, rng.CAMERA_BOUNCE, rng.DIM_JITTER,
                          dtype)
    s = ((pix % width).to(dtype) + ju) / (width - 1)
    r = ((height - 1) - (pix // width).to(dtype) + jv) / (height - 1)
    d = t(cam["corner"]) + s[:, None] * t(cam["horizontal"]) \
        + r[:, None] * t(cam["vertical"])
    o = t(cam["origin"]).expand_as(d)
    if cam["lens_radius"] != 0.0:
        lu, lv = rng.uniform2(seed, pix, samp, rng.CAMERA_BOUNCE,
                              rng.DIM_LENS, dtype)
        rad = cam["lens_radius"] * torch.sqrt(lu)
        phi = (2.0 * math.pi) * lv
        offset = ((rad * torch.cos(phi))[:, None] * t(cam["u"])
                  + (rad * torch.sin(phi))[:, None] * t(cam["v"]))
        o, d = o + offset, d - offset
    tu = rng.uniform2(seed, pix, samp, rng.CAMERA_BOUNCE, rng.DIM_TIME,
                      dtype)[0]
    time = cam["time0"] + tu * (cam["time1"] - cam["time0"])
    return o, d, time


def _rect_test(sc, ch, o, d, time, t_min, best):
    """(t, ok) [R, C] of the chunk's rects: the plane of the fixed axis,
    then the bounds of the two free ones (aarect.cpp)."""
    rect, sl = sc.rect, slice(ch.start, ch.end)
    axis = rect["axis"][sl]
    au = torch.where(axis == 0, 1, 0)
    av = torch.where(axis == 2, 1, 2)
    lo, hi = rect["lo"][sl], rect["hi"][sl]
    den = d[:, axis]
    t = (rect["k"][sl] - o[:, axis]) / den
    pu = o[:, au] + t * d[:, au]
    pv = o[:, av] + t * d[:, av]
    ok = ((den != 0) & (t > t_min) & (t < best[:, None]) & (pu >= lo[:, 0])
          & (pu <= hi[:, 0]) & (pv >= lo[:, 1]) & (pv <= hi[:, 1]))
    return t, ok


def _sphere_centres(sph, sl, time):
    """Centres [R, C, 3] (or [R, 3] for a sphere per ray) at the rays'
    times (moving_sphere.h ``center``)."""
    frac = (time - sph["t0"][sl]) / (sph["t1"][sl] - sph["t0"][sl])
    return sph["c0"][sl] + frac[..., None] * (sph["c1"][sl] - sph["c0"][sl])


def _sphere_test(sc, ch, o, d, time, t_min, best):
    """(t, ok) [R, C] of the chunk's spheres: the nearer root in range,
    else the farther (sphere.h ``hit``)."""
    sl = slice(ch.start, ch.end)
    oc = o[:, None, :] - _sphere_centres(sc.sph, sl, time[:, None])
    a = (d * d).sum(1)[:, None]
    half_b = (oc * d[:, None, :]).sum(2)
    r = sc.sph["r"][sl]
    disc = half_b * half_b - a * ((oc * oc).sum(2) - r * r)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    root1, root2 = (-half_b - sq) / a, (-half_b + sq) / a
    lim = best[:, None]
    root = torch.where((root1 > t_min) & (root1 < lim), root1, root2)
    return root, (disc >= 0) & (root > t_min) & (root < lim)


def _triangle_test(sc, ch, o, d, time, t_min, best):
    """(t, ok) [R, C] of the chunk's triangles: the plane, then the three
    edges' half-planes (triangle.h)."""
    tri, sl = sc.tri, slice(ch.start, ch.end)
    n, nv0 = tri["n"][sl], tri["nv0"][sl]
    m = tri["m"][sl].reshape(-1, 3)
    nd = d @ n.T
    t = (nv0 - o @ n.T) / nd
    w = ((o @ m.T).view(len(o), -1, 3)
         + t[..., None] * (d @ m.T).view(len(o), -1, 3) - tri["c"][sl])
    ok = ((nd != 0) & (t > t_min) & (t < best[:, None]) & (w >= 0).all(-1))
    return t, ok


TESTS = {scene_lib.RECT: _rect_test, scene_lib.SPHERE: _sphere_test,
         scene_lib.TRIANGLE: _triangle_test}


def _object_rays(sc, o, d, xf):
    if xf == 0:
        return o, d
    rot, tr = sc.xf_rot[xf], sc.xf_trans[xf]
    return (o - tr) @ rot, d @ rot


def _medium_interval(sc, medium, o, d):
    """(t1, t2, ok) of a medium's boundary: its entry and exit along the
    ray, and whether the ray crosses it."""
    kind, a, b, _, _, xf = medium
    ob, db = _object_rays(sc, o, d, xf)
    if kind == scene_lib.MED_SPHERE:
        radius = float(b[0])
        oc = ob - a
        qa = (db * db).sum(1)
        half_b = (oc * db).sum(1)
        disc = half_b * half_b - qa * ((oc * oc).sum(1) - radius * radius)
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        return (-half_b - sq) / qa, (-half_b + sq) / qa, disc > 0
    ta, tb = (a - ob) / db, (b - ob) / db
    t1 = torch.fmin(ta, tb).amax(1)
    t2 = torch.fmax(ta, tb).amin(1)
    return t1, t2, t1 < t2


def closest_hit(sc, o, d, time, u_med, t_min):
    """(t, kind, index) of the nearest hit past ``t_min``: kind a chunk
    kind (``scene.RECT``, ``SPHERE``, ``TRIANGLE``), ``MEDIUM`` or -1 for
    none.  The chunks in order (each against the rays that reach its box,
    in its transform's object space, where t is the world ray's t), then
    the media."""
    n_rays = o.shape[0]
    best = torch.full((n_rays,), math.inf, dtype=sc.dtype, device=o.device)
    kind = torch.full((n_rays,), -1, dtype=torch.int64, device=o.device)
    index = torch.zeros_like(kind)

    obj = {}
    for ch in sc.chunks:
        if ch.xf not in obj:
            ob, db = _object_rays(sc, o, d, ch.xf)
            obj[ch.xf] = (ob, db, 1.0 / db)
        ob, db, inv = obj[ch.xf]
        t0, t1 = (ch.lo - ob) * inv, (ch.hi - ob) * inv
        near = torch.fmin(t0, t1).amax(1)
        far = torch.fmax(t0, t1).amin(1)
        rays = torch.nonzero((far >= near) & (far > t_min)
                             & (near < best)).squeeze(1)
        for b0 in range(0, rays.shape[0], RAY_BLOCK):
            r = rays[b0:b0 + RAY_BLOCK]
            t, ok = TESTS[ch.kind](sc, ch, ob[r], db[r], time[r], t_min,
                                   best[r])
            tmin, j = torch.where(ok, t, math.inf).min(1)
            better = tmin < best[r]
            r = r[better]
            best[r] = tmin[better]
            kind[r] = ch.kind
            index[r] = j[better] + ch.start

    for q, medium in enumerate(sc.media):
        t1, t2, crossed = _medium_interval(sc, medium, o, d)
        r1 = torch.clamp_min(t1, t_min)
        r2 = torch.minimum(t2, best)
        ok = crossed & (t2 > t1 + MEDIUM_REHIT) & (r1 < r2)
        r1 = torch.clamp_min(r1, 0.0)
        length = torch.sqrt((d * d).sum(1))
        flight = medium[3] * torch.log(u_med[:, q])
        t = r1 + flight / length
        ok = ok & (flight <= (r2 - r1) * length) & (t < best)
        best = torch.where(ok, t, best)
        kind = torch.where(ok, MEDIUM, kind)
        index = torch.where(ok, q, index)
    return best, kind, index


def _sphere_record(sc, o, d, time, t, i):
    """(unit world normal, u, v) of sphere ``i`` [B] hit at ``t``: the
    outward normal in the sphere's object space, rotated to the world."""
    sph = sc.sph
    rot, tr = sc.xf_rot[sph["xf"][i]], sc.xf_trans[sph["xf"][i]]
    ob = ((o - tr)[:, None, :] @ rot)[:, 0]
    db = (d[:, None, :] @ rot)[:, 0]
    n = (ob + db * t[:, None] - _sphere_centres(sph, i, time)) \
        / sph["r"][i][:, None]
    theta = torch.acos(torch.clamp(-n[:, 1], -1.0, 1.0))
    phi = torch.atan2(-n[:, 2], n[:, 0]) + math.pi
    has_uv = sph["has_uv"][i]
    return ((rot @ n[:, :, None])[:, :, 0], phi / (2.0 * math.pi) * has_uv,
            theta / math.pi * has_uv)


def hit_record(sc, o, d, time, t, kind, index):
    """(point, unit normal facing the ray, material, tu, tv, front face) of
    rays that hit."""
    p = o + d * t[:, None]
    n = torch.zeros_like(o)
    mat = torch.zeros_like(kind)
    tu = torch.zeros_like(t)
    tv = torch.zeros_like(t)
    is_rect = kind == scene_lib.RECT
    is_sph = kind == scene_lib.SPHERE
    is_tri = kind == scene_lib.TRIANGLE
    is_med = kind == MEDIUM
    if sc.rect:
        i = index[is_rect]
        n[is_rect] = sc.rect["normal"][i]
        mat[is_rect] = sc.rect["mat"][i]
    if sc.sph:
        i = index[is_sph]
        n[is_sph], tu[is_sph], tv[is_sph] = _sphere_record(
            sc, o[is_sph], d[is_sph], time[is_sph], t[is_sph], i)
        mat[is_sph] = sc.sph["mat"][i]
    if sc.tri:
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
    if sc.media:
        n[is_med, 0] = 1.0
        mat[is_med] = torch.as_tensor([m[4] for m in sc.media],
                                      device=o.device)[index[is_med]]
    front = ((d * n).sum(1) < 0) | is_med
    n = torch.where(front[:, None], n, -n)
    return p, n, mat, tu, tv, front


def texture_value(sc, leaves, tex, tu, tv, p):
    """Albedo [B, 3] of textures ``tex`` at (tu, tv) and the point ``p``:
    solid colours from ``tex_ca``, checkers from ``tex_ca`` / ``tex_cb``,
    noise from the Perlin tables, image textures from the nearest texel of
    ``atlas``."""
    out = leaves["tex_ca"].index_select(0, tex)
    kinds = sc.tex_kinds
    kind = sc.tex_kind[tex]
    if scene_lib.CHECKER in kinds:
        sines = torch.sin(10.0 * p).prod(1)
        odd = (kind == scene_lib.CHECKER) & (sines < 0)
        out = torch.where(odd[:, None], leaves["tex_cb"].index_select(0, tex),
                          out)
    if scene_lib.NOISE in kinds:
        noisy = kind == scene_lib.NOISE
        q = p * sc.tex_scale[tex][:, None]
        gray = 0.5 * (1.0 + perlin.noise(sc.ranvec, sc.perm,
                                         sc.tex_noise[tex].clamp_min(0), q))
        out = torch.where(noisy[:, None], gray[:, None].expand_as(out), out)
    if scene_lib.IMAGE in kinds:
        image = kind == scene_lib.IMAGE
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


def _unit(v):
    return v / torch.sqrt((v * v).sum(1, keepdim=True))


def _reflect(v, n):
    return v - 2.0 * (v * n).sum(1, keepdim=True) * n


def scatter(sc, leaves, mk, mat, d, n, front, unit, seed, pix, samp, bounce):
    """(direction, absorbed) of the materials ``mk`` at the hits: the
    lambertian's direction, replaced by the metal's, the dielectric's and
    the isotropic medium's where those are the material."""
    dtype = sc.dtype
    new_d = n + unit
    new_d = torch.where((new_d.abs() < NEAR_ZERO).all(1, keepdim=True), n,
                        new_d)
    kinds = set(sc.mat_kind)
    absorbed = torch.zeros_like(mk, dtype=torch.bool)
    if kinds & {scene_lib.METAL, scene_lib.DIELECTRIC, scene_lib.ISOTROPIC}:
        u3, u4 = rng.uniform2(seed, pix, samp, bounce, rng.DIM_SCATTER_B,
                              dtype)
        ball = unit * torch.pow(u3, 1.0 / 3.0)[:, None]
    if kinds & {scene_lib.METAL, scene_lib.DIELECTRIC}:
        unit_d = _unit(d)
    if scene_lib.METAL in kinds:
        metal = mk == scene_lib.METAL
        fuzz = leaves["mat_fuzz"].index_select(0, mat)
        met_d = _reflect(unit_d, n) + fuzz[:, None] * ball
        new_d = torch.where(metal[:, None], met_d, new_d)
        absorbed = metal & ((met_d * n).sum(1) <= 0)
    if scene_lib.DIELECTRIC in kinds:
        ir = leaves["mat_ir"].index_select(0, mat)
        ratio = torch.where(front, 1.0 / ir, ir)
        cos = torch.clamp_max((-unit_d * n).sum(1), 1.0)
        sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 0.0))
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        reflect = ((ratio * sin > 1.0)
                   | (r0 + (1.0 - r0) * (1.0 - cos) ** 5 > u4))
        perp = ratio[:, None] * (unit_d + cos[:, None] * n)
        par = -torch.sqrt(torch.abs(1.0 - (perp * perp).sum(1)))[:, None] * n
        die_d = torch.where(reflect[:, None], _reflect(unit_d, n), perp + par)
        new_d = torch.where((mk == scene_lib.DIELECTRIC)[:, None], die_d,
                            new_d)
    if scene_lib.ISOTROPIC in kinds:
        new_d = torch.where((mk == scene_lib.ISOTROPIC)[:, None], ball, new_d)
    return new_d, absorbed


def trace(sc, leaves, acc, rows, o, d, time, pix, samp, seed, max_depth,
          t_min):
    """Trace paths (o, d) at ``time`` of (pixel, sample) = (pix, samp),
    adding each path's radiance into ``acc[rows]``.  Returns (acc,
    segments)."""
    dtype = sc.dtype
    mat_kind = torch.as_tensor(sc.mat_kind, device=o.device)
    thr = torch.ones_like(o)
    segments = o.shape[0]
    for bounce in range(max_depth):
        if o.shape[0] == 0:
            break
        u_med = (torch.stack([rng.uniform2(seed, pix, samp, bounce,
                                           rng.DIM_MEDIUM + 2 * q, dtype)[0]
                              for q in range(len(sc.media))], 1)
                 if sc.media else None)
        t, kind, index = closest_hit(sc, o, d, time, u_med, t_min)
        hit = kind >= 0
        miss = ~hit
        if bool(miss.any()):
            acc = _add(acc, rows[miss], thr[miss] * leaves["background"])
        o, d, time, thr, pix, samp, rows, t, kind, index = (
            x[hit] for x in (o, d, time, thr, pix, samp, rows, t, kind,
                             index))
        p, n, mat, tu, tv, front = hit_record(sc, o, d, time, t, kind, index)
        mk = mat_kind[mat]
        albedo = texture_value(sc, leaves, sc.mat_tex[mat], tu, tv, p)
        light = mk == scene_lib.DIFFUSE_LIGHT
        if bool(light.any()):
            acc = _add(acc, rows[light], thr[light] * albedo[light])
        u1, u2 = rng.uniform2(seed, pix, samp, bounce, rng.DIM_SCATTER_A,
                              dtype)
        z = 1.0 - 2.0 * u1
        rad = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        phi = (2.0 * math.pi) * u2
        unit = torch.stack((rad * torch.cos(phi), rad * torch.sin(phi), z), 1)
        new_d, absorbed = scatter(sc, leaves, mk, mat, d, n, front, unit,
                                  seed, pix, samp, bounce)
        albedo = torch.where((mk == scene_lib.DIELECTRIC)[:, None], 1.0,
                             albedo)
        keep = ~light & ~absorbed
        thr = thr * albedo
        o, d, time, thr, pix, samp, rows = (
            x[keep] for x in (p, new_d, time, thr, pix, samp, rows))
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
        o, d, time = primary_rays(cam, pix, samp, seed, width, height,
                                  sc.dtype)
        acc, segs = trace(sc, leaves, acc, rows, o, d, time, pix, samp, seed,
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
