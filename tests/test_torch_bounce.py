"""The bounce kernel's parts that run without a card: the per-scene packing
of its tables (``ops/kernels/bounce_kernel.py`` ``pack_tables``, read back
against the scene's tensors), its launch arguments' layout, K5's chained
winners (``intersect.tree_winners``) against the eager chain, the CPU's
eager step, the launch counter and the ``step`` count of the wavefront's
iteration spans with ``wavefront.bounce_share``'s reader.  No JAX; the
kernel itself is held to the eager step on the card
(``tests/test_torch_bounce_cuda.py``)."""

import ctypes
import json

import pytest
import torch

from another_raytracer_tpu_torch.config import RenderConfig
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import (camera, integrator, intersect,
                                            kernels, render)
from another_raytracer_tpu_torch.ops.kernels import bounce_kernel
from another_raytracer_tpu_torch.utils import profiling

W, H = 16, 12
LIBRARY = ("random_scene", "two_spheres", "two_perlin_spheres", "earth",
           "simple_light", "cornell_box", "cornell_smoke", "final_scene")
BENCH = ("cornell_box", "mesh_capsule", "final_scene")


def _bench(name, tmp):
    from benchmark import harness, inputs, scenes

    cfg = json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())
    return scenes.build(cfg, inputs.write_inputs(cfg, str(tmp)), W, H, "cpu")


def _library(name):
    scene, params = getattr(library, name)(device="cpu")
    return scene, camera.make_camera(aspect_ratio=W / H, device="cpu",
                                     **params)


def _section(table, layout, name, width):
    first, rows = layout[name]
    return table[first:first + rows].reshape(-1, width)


@pytest.mark.parametrize("name", [f"bench:{n}" for n in BENCH]
                         + [f"library:{n}" for n in LIBRARY])
def test_tables_read_back(name, tmp_path):
    """Every column of the packed tables is the scene's, row for row, and
    the padding is zero; the scene packs them once."""
    kind, _, scene_name = name.partition(":")
    scene = (_bench(scene_name, tmp_path) if kind == "bench"
             else _library(scene_name))[0]
    f, i, layout = scene.bounce_tables()
    assert scene.bounce_tables()[0] is f
    assert f.dtype == torch.float32 and i.dtype == torch.int32
    assert f.shape[1] == i.shape[1] == 4
    s = scene
    want_f = {
        "xf": [s.xf_rot.reshape(-1, 9), s.xf_trans],
        "sph": [s.sph_c0, s.sph_c1, s.sph_t0[:, None], s.sph_t1[:, None],
                s.sph_r[:, None], s.sph_has_uv[:, None]],
        "rect": [s.rect_k[:, None], s.rect_lo, s.rect_hi],
        "tri": [s.tri_v0, s.tri_v1, s.tri_v2, s.tri_uv0, s.tri_uv1,
                s.tri_uv2],
        "med": [s.med_a, s.med_b, s.med_neg_inv_density[:, None]],
        "mat": [s.mat_fuzz[:, None], s.mat_ir[:, None]],
        "tex": [s.tex_ca, s.tex_cb, s.tex_cc, s.tex_scale[:, None]],
        "bg": [s.background[None, :]],
    }
    want_i = {
        "sph_i": [s.sph_mat, s.sph_xf], "rect_i": [s.rect_axis, s.rect_mat,
                                                  s.rect_xf],
        "tri_i": [s.tri_mat, s.tri_xf], "med_i": [s.med_kind, s.med_mat,
                                                 s.med_xf],
        "mat_i": [s.mat_kind, s.mat_tex], "tex_i": [s.tex_kind, s.tex_aux],
        "img_i": [s.img_off, s.img_w, s.img_h],
    }
    covered = 0
    for sec, f4 in bounce_kernel.FLOAT_ROWS:
        rows = _section(f, layout, sec, 4 * f4)
        cols = torch.cat([c.flatten(1) for c in want_f[sec]], 1)
        assert rows.shape[0] == cols.shape[0], sec
        assert torch.equal(rows[:, :cols.shape[1]], cols), sec
        assert not rows[:, cols.shape[1]:].any(), sec
        covered += layout[sec][1]
    assert covered == f.shape[0]
    covered = 0
    for sec in bounce_kernel.INT_SECTIONS:
        rows = _section(i, layout, sec, 4)
        cols = torch.stack([c.to(torch.int32) for c in want_i[sec]], 1)
        assert torch.equal(rows[:, :cols.shape[1]], cols), sec
        assert not rows[:, cols.shape[1]:].any(), sec
        covered += layout[sec][1]
    assert covered == i.shape[0]


def test_tables_follow_their_sources():
    """A copy of the scene that swaps a source tensor packs again; one that
    keeps them shares the tables."""
    scene = _library("simple_light")[0]
    f = scene.bounce_tables()[0]
    assert scene.replace().bounce_tables()[0] is f
    brighter = scene.replace(tex_ca=scene.tex_ca * 2.0)
    f2 = brighter.bounce_tables()[0]
    assert f2 is not f and not torch.equal(f2, f)


def test_params_layout():
    """Every field of the launch arguments is 8 bytes wide and 8-aligned, so
    the C struct of ``csrc/bounce_kernel.cu`` lays out the same."""
    p = bounce_kernel.Params
    n = 0
    for name, typ in p._fields_:
        field = getattr(p, name)
        assert field.offset == 8 * n, name
        assert ctypes.sizeof(typ) % 8 == 0, name
        n += ctypes.sizeof(typ) // 8
    assert ctypes.sizeof(p) == 8 * n
    source = (bounce_kernel.__file__.rsplit("/ops/", 1)[0]
              + "/csrc/bounce_kernel.cu")
    text = open(source).read()
    for name, _ in p._fields_:
        assert name in text, name


def _flat(values):
    return [c for v in values for c in (v if isinstance(v, tuple) else (v,))]


def _eager_chain(scene, o, d, time, fold):
    """The tree part of the closest hit as it stood before the trees were
    chained on (t, code): each tree's launch starts from the running (t,
    idx) and decodes its code only where that tree improved.  Returns
    (t, kind, idx) and the folded record, tagged with its tree."""
    from another_raytracer_tpu_torch.ops.kernels import bvh_kernel

    z = o.x * 0.0
    best = (z + intersect.BIG, torch.full_like(z, -1, dtype=torch.int64),
            torch.zeros_like(z, dtype=torch.int64))
    aux = None
    for prim, n, nodes, rows in (
            ("planar", scene.n_bvh_nodes, scene.bvh_packed_nodes,
             scene.bvh_packed_tris),
            ("rect", scene.n_rect_bvh_nodes, scene.rect_bvh_nodes,
             scene.rect_bvh_rows),
            ("sphere", scene.n_sph_bvh_nodes, scene.sph_bvh_nodes,
             scene.sph_bvh_rows)):
        if not n:
            continue
        bt, bk, bi = best
        record, full, pre = intersect.k5_variant(prim, fold)
        out = bvh_kernel.bvh_closest_hit(
            nodes, rows, o, d, bt, bi.to(torch.int32), t_min=1e-3,
            leaf_size=scene.bvh_leaf_size, prim=prim, time=time,
            fold_record=record, fold_full=full, precomp=pre)
        t, code, improved = out[:3]
        code = code.long()
        best = (t, torch.where(improved, code % 4, bk),
                torch.where(improved, code // 4, bi))
        if record:
            aux = (prim,) + tuple(out[3:])
    return best, aux


@pytest.mark.parametrize("name,width,fold", [
    ("random_scene", 64, None), ("random_scene", 4096, "sphere"),
    ("final_scene", 64, None), ("final_scene", 4096, "sphere")])
def test_tree_winners_decode_to_the_eager_chain(name, width, fold,
                                                monkeypatch):
    """K5's launches chained on (t, code), as the kernel step runs them,
    decode to the eager chain's (t, kind, idx) and give its folded record
    (K5's plain version, on the CPU)."""
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", 4096)
    scene, cam = _library(name)
    assert intersect.fold_tree(scene, width) == fold
    pix = torch.arange(width) % (W * H)
    o, d, time = camera.generate_rays(cam, pix, pix // (W * H), W, H, 7,
                                      needs_time=scene.has_motion)
    init = (torch.full((width,), intersect.BIG),
            torch.full((width,), -1, dtype=torch.int32))
    t, code, folded = intersect.tree_winners(scene, o, d, time, 1e-3, fold,
                                             init)
    (bt, bk, bi), want_aux = _eager_chain(scene, o, d, time, fold)
    code = code.long()
    assert torch.equal(t, bt)
    assert torch.equal(torch.where(code >= 0, code % 4, -1), bk)
    assert torch.equal(torch.where(code >= 0, code // 4, 0), bi)
    assert (bk >= 0).any()
    if not (scene.n_media or scene.n_spheres and not scene.sph_in_bvh
            or scene.n_rects and not scene.rect_in_bvh
            or scene.n_triangles and not scene.tri_in_bvh):
        # Trees alone: closest_hit's decode of the chain is the per-tree one.
        got = intersect.closest_hit(scene, o, d, time, None, 1e-3, fold)
        if fold is not None:
            got, got_aux = got
            assert got_aux[0] == want_aux[0] == fold
            assert all(torch.equal(a, b) for a, b in
                       zip(_flat(got_aux[1:]), _flat(want_aux[1:])))
        assert all(torch.equal(a, b) for a, b in zip(got, (bt, bk, bi)))
    if fold is None:
        assert folded is None and want_aux is None
    else:
        rows = folded[0].x.untyped_storage()
        got = torch.empty(0).set_(rows).reshape(-1, width)
        want = torch.stack([want_aux[1].x, want_aux[1].y, want_aux[1].z,
                            *want_aux[2:]])
        assert torch.equal(got[:want.shape[0]], want)


def test_cpu_lanes_take_the_eager_step():
    """CPU lanes step through the eager step, launching nothing."""
    scene, cam = _library("two_perlin_spheres")
    pix = torch.arange(W * H)
    parts = integrator._regen_step_parts(scene, cam, pix, 3, W, H, 1, 2, 4,
                                         1e-3)
    assert parts[1].kind == "eager"
    kernels.reset_launch_counts()
    render.render(scene, cam, RenderConfig(width=W, height=H,
                                           samples_per_pixel=2, max_depth=4))
    assert kernels.launch_counts()["bounce"] == 0


def test_launch_counts_have_the_bounce_kernel():
    kernels.reset_launch_counts()
    counts = kernels.launch_counts()
    assert counts["bounce"] == 0 and list(counts)[-1] == "bounce"
    kernels.count("bounce", 3)
    assert kernels.launch_counts()["bounce"] == 3
    kernels.reset_launch_counts()


def test_the_kernel_refuses_cpu_tensors():
    """The kernel step on CPU lanes raises before any launch."""
    scene, cam = _library("two_perlin_spheres")
    pix = torch.arange(W * H)
    cam_rays, step, _ = integrator._kernel_step_parts(
        scene, cam, pix, 3, W, H, 1, 2, 4, 1e-3)
    assert step.kind == "kernel"
    state = integrator._regen_initial_state(cam_rays, torch.zeros_like(pix),
                                            2)
    with pytest.raises(ValueError, match="CUDA"):
        step(state)


def _run(traced=True):
    from benchmark import harness, trace

    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.cell(bench, "mesh_capsule.render")
    reading = trace.Reading(n=2, window_s=1.0, busy_s=0.5, ops=10,
                            breakdown={}) if traced else None
    return harness.Run(cell=cell, setup_s=1.0, latencies=[1.0], counts={},
                       traced=reading)


def _reader():
    from benchmark import harness

    return harness.load_module("metrics", "wavefront.bounce_share")


def test_iteration_spans_count_the_step_on_a_recorded_trace():
    """A CPU render recorded: every iteration span says its step was the
    eager one, and the reader reads 0%."""
    scene, cam = _library("simple_light")
    profiling.clear_spans()
    with profiling.recording():
        render.render(scene, cam, RenderConfig(width=W, height=H,
                                               samples_per_pixel=2,
                                               max_depth=4))
    spans = profiling.spans()
    its = [s for s in spans if s.name == "wavefront.iteration"]
    assert its and {s.attrs["step"] for s in its} == {"eager"}
    try:
        assert _reader().read(_run()) == 0.0
        assert _reader().read(_run(traced=False)) is None
    finally:
        profiling.clear_spans()


def _iterations(*steps):
    def span(name, start, end, parent=-1, **attrs):
        return profiling.Span(name, float(start), float(end), parent, 0,
                              attrs)

    out = [span("render", 0, 1000), span("wavefront", 10, 900, 0)]
    for k, step in enumerate(steps):
        attrs = {} if step is None else {"step": step}
        out.append(span("wavefront.iteration", 20 + 10 * k, 25 + 10 * k, 1,
                        width=8, alive=4, graph="replay", **attrs))
    return out


@pytest.mark.parametrize("steps,want", [
    (("kernel",) * 3, 100.0), (("eager", "kernel", "kernel", "kernel"), 75.0),
    (("eager",), 0.0), ((), None), (("kernel", None), None), ((None,), None)])
def test_bounce_share_reader(steps, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _iterations(*steps))
    got = _reader().read(_run())
    assert got == (None if want is None else pytest.approx(want))


def test_a_captured_stage_keeps_its_step_parts(monkeypatch):
    """A stage keeps the step and re-arm it captured, since its graphs read
    the buffers they hold (the kernel step's re-arm mask, flag and K5's
    first inputs); the capture injected as ``test_torch_graphs.py`` does."""
    import collections

    monkeypatch.setitem(integrator.GRAPHS, "cpu",
                        lambda device: (lambda fn: fn))
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    scene, cam = _library("two_perlin_spheres")
    for seed in (3, 4):
        render.render(scene, cam, RenderConfig(width=W, height=H,
                                               samples_per_pixel=2,
                                               max_depth=4, seed=seed))
    replayed = [st for st in integrator._stages.values()
                if st.mode == "replay"]
    assert replayed
    for st in replayed:
        assert st._step.kind == "eager" and callable(st._rearm)


def test_trace_scene_names_the_bounce_kernel():
    """``trace_scene`` puts the bounce kernel in a category of its own."""
    from another_raytracer_tpu_torch import trace_scene

    event = {"name": "void (anonymous namespace)::bounce_kernel<1, true>("
                     "(anonymous namespace)::Params)", "cat": "kernel"}
    assert trace_scene.category(event) == "bounce (wavefront step after K5)"
