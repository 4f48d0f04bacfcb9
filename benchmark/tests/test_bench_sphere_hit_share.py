"""``render.sphere_hit_share``: the traced renders' ``sphere_hits`` over
their ``segments`` (the ``render`` span's counts), in %, on synthetic spans
and on a render of the port on the CPU; None where the run was not traced,
the program records no spans, or its ``render`` span counts no sphere hits
(a scene without spheres, or a tree from before it counted them)."""

import pytest

from another_raytracer_tpu_torch.utils import profiling
from benchmark import harness, inputs, scenes
from test_bench_segments_per_sample import H, SPP, W, _run, _span


def _renders(*counts):
    """One root ``render`` span a (segments, sphere_hits) pair, each with a
    child; a None count is left out of the span."""
    spans = []
    for i, (seg, hits) in enumerate(counts):
        attrs = {k: v for k, v in (("segments", seg), ("sphere_hits", hits))
                 if v is not None}
        spans.append(_span("render", 1000 * i, 1000 * i + 900, request=i,
                           mode="single", **attrs))
        spans.append(_span("render.wait", 1000 * i + 800, 1000 * i + 890,
                           len(spans) - 1, request=i))
    return spans


def _reader():
    return harness.load_module("metrics", "render.sphere_hit_share")


def test_share_of_the_segments(monkeypatch):
    monkeypatch.setattr(profiling, "spans",
                        lambda: _renders((400, 50), (600, 100)))
    assert _reader().read(_run()) == pytest.approx(15.0)
    assert _reader().read(_run(traced=False)) is None


@pytest.mark.parametrize("spans", [[], _renders((400, None), (500, None)),
                                   _renders((None, None))])
def test_nothing_to_read(spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    assert _reader().read(_run()) is None


def test_without_program_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _reader().read(_run()) is None


@pytest.mark.parametrize("cell,reads", [("final_scene.render", True),
                                        ("cornell_box.render", False)])
def test_reads_the_port_s_render_span(cell, reads, tmp_path):
    """A render of the cell's configuration on the CPU inside
    ``profiling.recording()``: the metric reads the span's counts where the
    scene has spheres, and nothing where it has none."""
    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import render as render_lib

    run = _run(cell, n=1)
    cfg = run.cell.config
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), W, H,
                              "cpu")
    profiling.clear_spans()
    try:
        with profiling.recording():
            render_lib.render(scene, cam, RenderConfig(
                width=W, height=H, samples_per_pixel=SPP, max_depth=8,
                seed=5))
        attrs = [s.attrs for s in profiling.spans() if s.name == "render"][0]
        got = _reader().read(run)
        if reads:
            assert got == pytest.approx(
                100.0 * attrs["sphere_hits"] / attrs["segments"])
            assert 0 < got < 100
        else:
            assert got is None and "sphere_hits" not in attrs
    finally:
        profiling.clear_spans()
