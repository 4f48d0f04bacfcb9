"""``render.segments_per_sample``: the traced renders' ``segments`` counts
(the ``render`` span's) over width x height x spp, on synthetic spans and
on a render of the port on the CPU; None where the run was not traced, the
program records no spans, or its ``render`` span counts no segments (a
tree from before it did)."""

import json

import pytest

from benchmark import harness, inputs, scenes, trace
from another_raytracer_tpu_torch.utils import profiling

W, H, SPP = 12, 12, 2  # the traffic's sizes, overridden


def _span(name, start, end, parent=-1, request=0, **attrs):
    return profiling.Span(name, float(start), float(end), parent, request,
                          attrs)


def _renders(*segments):
    """One root ``render`` span a count, each with a child; None: a render
    span without the count."""
    spans = []
    for i, seg in enumerate(segments):
        counts = {} if seg is None else {"segments": seg}
        spans.append(_span("render", 1000 * i, 1000 * i + 900, request=i,
                           mode="single", **counts))
        spans.append(_span("render.wait", 1000 * i + 800, 1000 * i + 890,
                           len(spans) - 1, request=i))
    return spans


def _run(cell="final_scene.render", traced=True, n=2):
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    c = harness.cell(bench, cell, overrides={"width": W, "height": H,
                                             "spp": SPP})
    reading = trace.Reading(n=n, window_s=1.0, busy_s=0.5, ops=10,
                            breakdown={}) if traced else None
    return harness.Run(cell=c, setup_s=1.0, latencies=[1.0], counts={},
                       traced=reading)


@pytest.mark.parametrize("cell", ["cornell_box.render",
                                  "mesh_capsule.render",
                                  "final_scene.render"])
def test_mean_segments_over_the_samples(cell, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _renders(400, 500))
    reader = harness.load_module("metrics", "render.segments_per_sample")
    assert reader.read(_run(cell)) == pytest.approx(450 / (W * H * SPP))
    assert reader.read(_run(cell, traced=False)) is None


@pytest.mark.parametrize("spans", [[], _renders(None, None)])
def test_nothing_to_read(spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    reader = harness.load_module("metrics", "render.segments_per_sample")
    assert reader.read(_run()) is None


def test_without_program_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    reader = harness.load_module("metrics", "render.segments_per_sample")
    assert reader.read(_run()) is None


def test_reads_the_port_s_render_span(tmp_path):
    """A render of the configuration on the CPU inside
    ``profiling.recording()``: the metric reads its ``segments``."""
    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import render as render_lib

    run = _run(n=1)
    cfg = run.cell.config
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), W, H,
                              "cpu")
    profiling.clear_spans()
    try:
        with profiling.recording():
            _, stats = render_lib.render(scene, cam, RenderConfig(
                width=W, height=H, samples_per_pixel=SPP, max_depth=8,
                seed=5))
        reader = harness.load_module("metrics", "render.segments_per_sample")
        assert reader.read(run) == pytest.approx(
            stats["segments"] / (W * H * SPP))
    finally:
        profiling.clear_spans()
