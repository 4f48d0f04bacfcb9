"""``render.medium_scatter_share``: the traced renders' ``medium_scatters``
over their ``segments`` (the ``render`` span's counts), in %, on synthetic
spans and on a render of the port on the CPU; None where the run was not
traced, the program records no spans, or its ``render`` spans count no
medium scatters, as a tree from before the count records them: the reader
runs with the benchmark's files over such a tree and has to read nothing
there, not raise."""

import ast

import pytest

from another_raytracer_tpu_torch.utils import profiling
from benchmark import harness, inputs, scenes
from test_bench_segments_per_sample import H, SPP, W, _run, _span

CELL = "cornell_smoke.render"


def _renders(*counts):
    """One root ``render`` span a (segments, medium_scatters) pair, each
    with a child; a None count is left out of the span."""
    spans = []
    for i, (seg, scatters) in enumerate(counts):
        attrs = {k: v for k, v in (("segments", seg),
                                   ("medium_scatters", scatters))
                 if v is not None}
        spans.append(_span("render", 1000 * i, 1000 * i + 900, request=i,
                           mode="single", **attrs))
        spans.append(_span("render.wait", 1000 * i + 800, 1000 * i + 890,
                           len(spans) - 1, request=i))
    return spans


def _reader():
    return harness.load_module("metrics", "render.medium_scatter_share")


def test_share_of_the_segments(monkeypatch):
    monkeypatch.setattr(profiling, "spans",
                        lambda: _renders((400, 100), (600, 110)))
    assert _reader().read(_run(CELL)) == pytest.approx(21.0)


def test_an_untraced_run_reads_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "spans",
                        lambda: _renders((400, 100), (600, 110)))
    assert _reader().read(_run(CELL, traced=False)) is None


@pytest.mark.parametrize("spans", [
    [],
    # The parent's spans: segments and the span's other counts, no
    # medium_scatters.
    _renders((400, None), (500, None)),
    _renders((None, None)),
    # A count beside no segments, and children of a root with the count.
    _renders((0, 5)),
    [_span("render", 0, 900, mode="single", segments=400),
     _span("render", 100, 800, 0, medium_scatters=50, segments=300)],
])
def test_spans_without_the_count_read_nothing(spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    assert _reader().read(_run(CELL)) is None


def test_without_program_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _reader().read(_run(CELL)) is None


def test_imports_nothing_of_the_program():
    """The reader imports ``benchmark.spans`` alone, which owns the one
    access to the program's spans."""
    path = harness.ROOT / "metrics" / "render.medium_scatter_share.py"
    imported = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    assert imported == {"benchmark.spans"}


@pytest.mark.parametrize("counted", [True, False])
def test_reads_the_port_s_render_span(counted, tmp_path, monkeypatch):
    """A render of the cell's configuration on the CPU inside
    ``profiling.recording()``: the metric reads the span's counts, and
    nothing where the program does not count medium scatters (its
    ``trace_regenerative`` fills no ``medium_scatters``, as before the
    count)."""
    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.ops import integrator
    from another_raytracer_tpu_torch.ops import render as render_lib

    if not counted:
        real = integrator.trace_regenerative

        def uncounted(*a, counts=None, **k):
            out = real(*a, counts=counts, **k)
            if counts is not None:
                counts.pop("medium_scatters", None)
            return out

        monkeypatch.setattr(integrator, "trace_regenerative", uncounted)
    run = _run(CELL, n=1)
    cfg = run.cell.config
    scene, cam = scenes.build(cfg, inputs.write_inputs(cfg, tmp_path), W, H,
                              "cpu")
    profiling.clear_spans()
    try:
        with profiling.recording():
            render_lib.render(scene, cam, RenderConfig(
                width=W, height=H, samples_per_pixel=SPP, max_depth=50,
                seed=5))
        attrs = [s.attrs for s in profiling.spans() if s.name == "render"][0]
        got = _reader().read(run)
        if counted:
            assert got == pytest.approx(
                100.0 * attrs["medium_scatters"] / attrs["segments"])
            assert 0 < got < 100
        else:
            assert got is None and "medium_scatters" not in attrs
    finally:
        profiling.clear_spans()
