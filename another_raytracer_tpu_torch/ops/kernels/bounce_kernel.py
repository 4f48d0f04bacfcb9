"""The bounce kernel: the regenerating wavefront's step after K5 in one
launch (``csrc/bounce_kernel.cu``).

* ``launch`` is the wrapper: on CUDA tensors it launches the kernel over a
  stage's carry, after K5's chained winners (``intersect.tree_winners``),
  or raises; ``prepare_launch`` is everything one launch needs.
  ``integrator._kernel_step_parts`` calls it on every CUDA step of
  ``trace_regenerative``; the eager step (``integrator._eager_step_parts``)
  followed by its re-arm is its plain version, which CPU tensors run.
* ``camera_fields`` reads the camera's launch arguments off the card, once
  a stage.
* ``pack_tables`` packs a scene's primitive, transform, material, texture,
  medium and image tables for the kernel, once per scene
  (``SceneData.bounce_tables``).

It replaces no TPU kernel: the JAX package's XLA fuses the step's per-lane
arithmetic into a few loop fusions, where eager PyTorch launches ~650-1,000
elementwise kernels an iteration.  The kernel runs the eager step's
operations in its order, and gives each lane whose path ends with samples
left its next sample's camera ray, so the carry it writes is the eager step
followed by its re-arm, bit for bit (``tests/test_torch_bounce_cuda.py``).
"""

from __future__ import annotations

import ctypes
import operator

import torch

from another_raytracer_tpu_torch.ops import kernels, rng

# K5's record fold (``intersect.fold_tree``) -> the kernel's instance.
FOLDS = {None: 0, "planar": 1, "sphere": 2}

# The packed tables, in order: float sections (16-byte rows of float4s) by
# (name, float4s a row), then int sections (one int4 a row).
FLOAT_ROWS = (("xf", 3), ("sph", 3), ("rect", 2), ("tri", 4), ("med", 2),
              ("mat", 1), ("tex", 3), ("bg", 1))
INT_SECTIONS = ("sph_i", "rect_i", "tri_i", "med_i", "mat_i", "tex_i",
                "img_i")

_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
# The carry's 15 float columns: o, d, throughput, total, path_rad.
N_FLOAT = 15
# The camera's float32 tensors that ``camera.generate_rays`` reads, by
# ``Params`` field: its 3-vectors (Camera attribute -> field) and scalars.
CAMERA_VECTORS = {"origin": "origin", "lower_left": "lower_left",
                  "horizontal": "horizontal", "vertical": "vertical",
                  "u": "cam_u", "v": "cam_v"}
CAMERA_SCALARS = ("lens_radius", "time0", "time1")
CAMERA_FIELDS = (("width", "height", "lens", "shutter")
                 + tuple(CAMERA_VECTORS.values()) + CAMERA_SCALARS)


class Params(ctypes.Structure):
    """``csrc/bounce_kernel.cu``'s Params, field for field (all 8 bytes)."""

    _fields_ = ([("in_f", _P * N_FLOAT), ("in_alive", _P), ("in_sample", _P),
                 ("in_bounce", _P), ("out_f", _P * N_FLOAT),
                 ("out_alive", _P), ("out_sample", _P), ("out_bounce", _P)]
                + [(n, _P) for n in (
                    "in_time", "out_time", "pix", "segments", "sphere_hits",
                    "medium_scatters", "seed_at", "k5_t", "k5_code", "aux")]
                + [(n, _P) for n, _ in FLOAT_ROWS]
                + [(n, _P) for n in INT_SECTIONS]
                + [("atlas", _P), ("perlin", _P)]
                + [(n, _I) for n in (
                    "n", "seed", "max_depth", "stride", "limit", "n_xf",
                    "n_sph", "n_rect", "n_tri", "n_med", "n_mat", "n_tex",
                    "n_img", "n_perlin", "sweep_sph", "sweep_rect",
                    "sweep_tri")]
                + [("t_min", _D)]
                + [(n, _I) for n in CAMERA_FIELDS[:4]]
                + [(n, _D * 3) for n in CAMERA_VECTORS.values()]
                + [(n, _D) for n in CAMERA_SCALARS])


def _rows(cols, width):
    """[N, width] float32 (or int32) rows of the [N] / [N, k] columns
    ``cols`` side by side, zero-padded."""
    cols = [c.detach().flatten(1) if c.dim() > 1 else c.detach()[:, None]
            for c in cols]
    dtype = cols[0].dtype
    a = torch.cat([c.to(dtype) for c in cols], 1)
    pad = width - a.shape[1]
    return torch.cat([a, a.new_zeros((a.shape[0], pad))], 1)


# The scene's fields that the tables are packed from.
SOURCES = ("xf_rot", "xf_trans", "sph_c0", "sph_c1", "sph_t0", "sph_t1",
           "sph_r", "sph_has_uv", "rect_k", "rect_lo", "rect_hi", "tri_v0",
           "tri_v1", "tri_v2", "tri_uv0", "tri_uv1", "tri_uv2", "med_a",
           "med_b", "med_neg_inv_density", "mat_fuzz", "mat_ir", "tex_ca",
           "tex_cb", "tex_cc", "tex_scale", "background", "sph_mat", "sph_xf",
           "rect_axis", "rect_mat", "rect_xf", "tri_mat", "tri_xf",
           "med_kind", "med_mat", "med_xf", "mat_kind", "mat_tex", "tex_kind",
           "tex_aux", "img_off", "img_w", "img_h")


def pack_tables(scene):
    """The kernel's tables of ``scene``: (floats [R, 4] float32, ints
    [S, 4] int32, {section: (first row, rows)}), on the scene's device.

    Float rows (four floats a float4): ``xf`` the rotation row-major and the
    translation; ``sph`` c0, c1, t0, t1, r, has_uv; ``rect`` k, lo_u, lo_v,
    hi_u, hi_v; ``tri`` v0, v1, v2, uv0, uv1, uv2; ``med`` a, b,
    neg_inv_density; ``mat`` fuzz, ir; ``tex`` ca, cb, cc, scale; ``bg`` the
    background.  Int rows: ``sph_i`` mat, xf; ``rect_i`` axis, mat, xf;
    ``tri_i`` mat, xf; ``med_i`` kind, mat, xf; ``mat_i`` kind, tex;
    ``tex_i`` kind, aux; ``img_i`` off, w, h.  Zeros pad each row."""
    s = scene
    floats = {
        "xf": _rows([s.xf_rot, s.xf_trans], 12),
        "sph": _rows([s.sph_c0, s.sph_c1, s.sph_t0, s.sph_t1, s.sph_r,
                      s.sph_has_uv], 12),
        "rect": _rows([s.rect_k, s.rect_lo, s.rect_hi], 8),
        "tri": _rows([s.tri_v0, s.tri_v1, s.tri_v2, s.tri_uv0, s.tri_uv1,
                      s.tri_uv2], 16),
        "med": _rows([s.med_a, s.med_b, s.med_neg_inv_density], 8),
        "mat": _rows([s.mat_fuzz, s.mat_ir], 4),
        "tex": _rows([s.tex_ca, s.tex_cb, s.tex_cc, s.tex_scale], 12),
        "bg": _rows([s.background[None, :]], 4),
    }
    ints = {
        "sph_i": _rows([s.sph_mat, s.sph_xf], 4),
        "rect_i": _rows([s.rect_axis, s.rect_mat, s.rect_xf], 4),
        "tri_i": _rows([s.tri_mat, s.tri_xf], 4),
        "med_i": _rows([s.med_kind, s.med_mat, s.med_xf], 4),
        "mat_i": _rows([s.mat_kind, s.mat_tex], 4),
        "tex_i": _rows([s.tex_kind, s.tex_aux], 4),
        "img_i": _rows([s.img_off, s.img_w, s.img_h], 4),
    }
    layout, at = {}, 0
    for name, f4 in FLOAT_ROWS:
        rows = floats[name].shape[0] * f4
        layout[name] = (at, rows)
        at += rows
    at = 0
    for name in INT_SECTIONS:
        rows = ints[name].shape[0]
        layout[name] = (at, rows)
        at += rows
    f = torch.cat([floats[n].to(torch.float32).reshape(-1, 4)
                   for n, _ in FLOAT_ROWS]).contiguous()
    i = torch.cat([ints[n].to(torch.int32) for n in INT_SECTIONS]).contiguous()
    return f, i, layout


_fn = None  # the bound C entry, once loaded


def _lib():
    global _fn
    if _fn is None:
        from another_raytracer_tpu_torch.ops.kernels import _build

        lib = _build.load("bounce_kernel")
        lib.art_bounce_params_size.restype = ctypes.c_int
        size = lib.art_bounce_params_size()
        if size != ctypes.sizeof(Params):
            raise RuntimeError(f"bounce kernel Params: {size} bytes in the "
                               f"library, {ctypes.sizeof(Params)} here")
        fn = lib.art_bounce
        fn.argtypes = [ctypes.POINTER(Params), ctypes.c_int, ctypes.c_int,
                       _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def camera_fields(cam, width, height, needs_time) -> dict:
    """The camera's launch arguments, {``Params`` field: value}, for a
    ``width`` x ``height`` image: the float32 values that
    ``camera.generate_rays`` reads (one transfer off the card), the lens
    switch (``cam.has_lens``) and the shutter's (``cam.has_time`` where
    ``needs_time``, the scene reads ray time: ``scene.has_motion``).  A
    launch takes the values read here: a camera changed in place later is
    not seen, as the scene's packed tables are not."""
    flat = torch.cat([getattr(cam, k).reshape(-1) for k in
                      (*CAMERA_VECTORS, *CAMERA_SCALARS)])
    if flat.dtype != torch.float32 or flat.numel() != 21:
        raise ValueError("the camera's tensors must be float32 3-vectors "
                         "and scalars")
    values = iter(flat.tolist())
    out = {"width": operator.index(width), "height": operator.index(height),
           "lens": int(bool(cam.has_lens)),
           "shutter": int(bool(cam.has_time and needs_time))}
    for field in CAMERA_VECTORS.values():
        out[field] = (next(values), next(values), next(values))
    out.update((field, next(values)) for field in CAMERA_SCALARS)
    return out


def _check(name, t, n, dtype, dev):
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or t.device != dev or t.shape != (n,) or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous [{n}] {dtype} tensor "
                         f"on {dev}")


def launch(scene, state, pix, seed, winners, **kw):
    """One step of the regenerating wavefront's lanes after K5: returns the
    next 10-tuple carry (``integrator._regen_step_parts``' ``step``),
    written into ``into`` (a carry whose tensors are buffers, the stage's:
    in place where it is ``state``) or into new tensors.  The arguments are
    ``prepare_launch``'s."""
    run, into = prepare_launch(scene, state, pix, seed, winners, **kw)
    if state[0].x.shape[0]:
        with torch.cuda.device(state[0].x.device):
            err = run()
        if err != 0:
            raise RuntimeError(f"bounce kernel launch failed: CUDA error "
                               f"{err}")
        kernels.count("bounce")
    return into


def prepare_launch(scene, state, pix, seed, winners, *, fold, camera,
                   sample_stride, limit, max_depth, t_min, sphere_hits=None,
                   medium_scatters=None, into=None):
    """Everything one launch needs: returns (run, the next carry).
    ``run()`` is the bare launch on the current stream and returns the CUDA
    error code.

    ``winners``: ``intersect.tree_winners``' (t, code, folded) or None (a
    scene without trees); ``fold``: ``intersect.fold_tree``'s answer at this
    width; ``camera``: ``camera_fields``' for the stage, which the lanes
    that end with samples left below ``limit`` take their next sample's
    ray from.  The segments (and the sphere winners into ``sphere_hits``
    and the medium winners, each a scatter in a medium, into
    ``medium_scatters``, each a 0-d int64) are added on the card.
    ``seed``: an int or a 0-d int64 tensor on the carry's device (read at
    launch, so a CUDA graph's replay takes the seed it holds then).  Raises
    on anything the kernel does not take."""
    (o, d, time, thr, total, prad, alive, sample, bounce, segments) = state
    dev, n = o.x.device, o.x.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"the bounce kernel needs CUDA tensors, not {dev}")
    fcols = (*o, *d, *thr, *total, *prad)
    for k, c in enumerate(fcols):
        _check(f"carry column {k}", c, n, torch.float32, dev)
    _check("time", time, n, torch.float32, dev)
    _check("alive", alive, n, torch.bool, dev)
    _check("sample", sample, n, torch.int64, dev)
    _check("bounce", bounce, n, torch.int64, dev)
    _check("pix", pix, n, torch.int64, dev)
    for name, t, dtype in (("segments", segments, torch.int64),
                           ("sphere_hits", sphere_hits, torch.int64),
                           ("medium_scatters", medium_scatters,
                            torch.int64)):
        if t is not None and (t.dtype != dtype or t.device != dev
                              or t.dim() != 0):
            raise ValueError(f"{name} must be a 0-d {dtype} tensor on {dev}")
    if fold not in FOLDS:
        raise ValueError(f"unknown fold {fold!r}")
    if (winners is None) != (not scene.has_accel) or (
            fold is not None and (winners is None or winners[2] is None)):
        raise ValueError("winners must be intersect.tree_winners' for this "
                         "scene and fold")
    if into is None:
        into = (type(o)(*(torch.empty_like(c) for c in o)),
                type(d)(*(torch.empty_like(c) for c in d)),
                torch.empty_like(time),
                type(thr)(*(torch.empty_like(c) for c in thr)),
                type(total)(*(torch.empty_like(c) for c in total)),
                type(prad)(*(torch.empty_like(c) for c in prad)),
                torch.empty_like(alive), torch.empty_like(sample),
                torch.empty_like(bounce), segments.clone())
    (o2, d2, time2, thr2, total2, prad2, alive2, sample2, bounce2,
     segments2) = into
    out_cols = (*o2, *d2, *thr2, *total2, *prad2)
    for k, c in enumerate(out_cols):
        _check(f"output column {k}", c, n, torch.float32, dev)
    _check("output time", time2, n, torch.float32, dev)

    f, i, layout = scene.bounce_tables()
    if f.device != dev:
        raise ValueError(f"scene is on {f.device}, the carry on {dev}")
    perlin = scene.perlin_tables()
    p = Params()
    p.in_f[:] = [c.data_ptr() for c in fcols]
    p.out_f[:] = [c.data_ptr() for c in out_cols]
    p.in_alive, p.in_sample, p.in_bounce = (alive.data_ptr(),
                                            sample.data_ptr(),
                                            bounce.data_ptr())
    p.out_alive, p.out_sample, p.out_bounce = (alive2.data_ptr(),
                                               sample2.data_ptr(),
                                               bounce2.data_ptr())
    p.in_time, p.out_time = time.data_ptr(), time2.data_ptr()
    p.pix, p.segments = pix.data_ptr(), segments2.data_ptr()
    p.sphere_hits = None if sphere_hits is None else sphere_hits.data_ptr()
    p.medium_scatters = (None if medium_scatters is None
                         else medium_scatters.data_ptr())
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.dim() != 0 or seed.device != dev:
            raise ValueError(f"a tensor seed must be a 0-d int64 tensor on "
                             f"{dev}")
        p.seed_at, p.seed = seed.data_ptr(), 0
    else:
        p.seed_at, p.seed = None, operator.index(seed) & rng.MASK32
    if winners is not None:
        t, code, folded = winners
        _check("K5's t", t, n, torch.float32, dev)
        _check("K5's code", code, n, torch.int32, dev)
        p.k5_t, p.k5_code = t.data_ptr(), code.data_ptr()
        # The fold's rows follow its first in one [rows, B] tensor.
        p.aux = None if folded is None else folded[0].x.data_ptr()
    for name, _ in FLOAT_ROWS:
        setattr(p, name, f.data_ptr() + 16 * layout[name][0])
    for name in INT_SECTIONS:
        setattr(p, name, i.data_ptr() + 16 * layout[name][0])
    atlas = scene.atlas
    if atlas.dtype != torch.float32 or not atlas.is_contiguous():
        raise ValueError("the atlas must be contiguous float32 [P, 3]")
    p.atlas, p.perlin = atlas.data_ptr(), perlin.data_ptr()
    p.n = n
    p.max_depth, p.stride, p.limit = (operator.index(max_depth),
                                      operator.index(sample_stride),
                                      operator.index(limit))
    p.n_xf = scene.xf_rot.shape[0]
    p.n_sph, p.n_rect, p.n_tri, p.n_med = (scene.n_spheres, scene.n_rects,
                                           scene.n_triangles, scene.n_media)
    p.n_mat, p.n_tex = scene.mat_kind.shape[0], scene.tex_kind.shape[0]
    p.n_img, p.n_perlin = scene.img_off.shape[0], perlin.shape[0]
    p.sweep_sph = int(bool(scene.n_spheres) and not scene.sph_in_bvh)
    p.sweep_rect = int(bool(scene.n_rects) and not scene.rect_in_bvh)
    p.sweep_tri = int(bool(scene.n_triangles) and not scene.tri_in_bvh)
    p.t_min = float(t_min)
    if set(camera) != set(CAMERA_FIELDS):
        raise ValueError("camera must be camera_fields' for the stage")
    for field, value in camera.items():
        setattr(p, field, value)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    instance = (FOLDS[fold], int(scene.n_media > 0))

    def run(_inputs=(state, into, pix, seed, winners, sphere_hits,
                     medium_scatters, f, i, perlin, atlas)):
        # The default keeps the tensors behind p's pointers alive.
        return fn(ctypes.byref(p), *instance, stream)

    return run, into
