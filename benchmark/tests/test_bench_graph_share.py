"""``wavefront.graph_share`` on synthetic spans: the share of the traced
renders' iteration spans that replayed graphs, and None where the run was
not traced, the program records no spans or no iterations, or its
iterations carry no ``graph`` count (a tree from before they did)."""

import json

import pytest

from benchmark import harness, trace
from another_raytracer_tpu_torch.utils import profiling


def _span(name, start, end, parent=-1, request=0, **attrs):
    return profiling.Span(name, float(start), float(end), parent, request,
                          attrs)


def _iterations(*modes):
    """A render whose wavefront runs one iteration a mode; None: an
    iteration span without the ``graph`` count."""
    spans = [_span("render", 0, 1000), _span("wavefront", 10, 900, 0)]
    for i, mode in enumerate(modes):
        graph = {} if mode is None else {"graph": mode}
        spans.append(_span("wavefront.iteration", 20 + 10 * i, 25 + 10 * i,
                           1, width=8, alive=4, **graph))
    return spans


def _run(traced=True):
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.cell(bench, "mesh_capsule.render")
    reading = trace.Reading(n=2, window_s=1.0, busy_s=0.5, ops=10,
                            breakdown={}) if traced else None
    return harness.Run(cell=cell, setup_s=1.0, latencies=[1.0], counts={},
                       traced=reading)


@pytest.mark.parametrize("modes,want", [
    (("replay",) * 4, 100.0),
    (("eager", "capture", "replay", "replay"), 50.0),
    (("eager", "capture"), 0.0),
    (("replay", "replay", "replay", "eager", "capture"), 60.0),
])
def test_share_of_replays(modes, want, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: _iterations(*modes))
    reader = harness.load_module("metrics", "wavefront.graph_share")
    assert reader.read(_run()) == pytest.approx(want)
    assert reader.read(_run(traced=False)) is None


@pytest.mark.parametrize("spans", [
    [], _iterations(), _iterations(None, None), _iterations("replay", None)])
def test_nothing_to_read(spans, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    reader = harness.load_module("metrics", "wavefront.graph_share")
    assert reader.read(_run()) is None


def test_without_program_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    reader = harness.load_module("metrics", "wavefront.graph_share")
    assert reader.read(_run()) is None
