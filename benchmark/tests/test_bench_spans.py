"""The readers of the program's spans: each on a fake traced run returns
what its spans say, and None where the run was not traced or the program
records no spans (a tree from before it did).  Then the same readers on the
spans of real CPU renders, against a counting wrapper of the wavefront's
loop body."""

import json

import pytest

from benchmark import harness, trace
from another_raytracer_tpu_torch.utils import profiling

READERS = ("mega.prepare_ms", "render.host_ms", "wavefront.iterations",
           "wavefront.lane_occupancy", "wavefront.waits",
           "adaptive.lanes_per_launch", "train.host_ms")


def _span(name, start, end, parent=-1, request=0, **attrs):
    return profiling.Span(name, float(start), float(end), parent, request,
                          attrs)


# Two renders of 1000 and 1200 us: the first a sweep (a mega.prepare of
# 300 us, a render.wait of 400 us), the second the wavefront (two
# iterations of 8 lanes, 6 and 2 alive; four waits of 10 us, one inside an
# iteration; an adaptive level of 96 lanes; a render.wait of 100 us).  A
# train step of 500 us with a wait of 50 us.
FAKE = [
    _span("render", 0, 1000),
    _span("mega.prepare", 100, 400, 0),
    _span("render.wait", 500, 900, 0),
    _span("render", 2000, 3200, request=1),
    _span("adaptive.level", 2010, 2900, 3, 1, level=0, lanes=96),
    _span("wavefront", 2020, 2800, 4, 1, lanes=8, stages=1),
    _span("wavefront.wait", 2030, 2040, 5, 1, what="alive"),
    _span("wavefront.iteration", 2040, 2400, 5, 1, width=8, alive=6),
    _span("wavefront.wait", 2300, 2310, 7, 1, what="regen"),
    _span("wavefront.wait", 2400, 2410, 5, 1, what="alive"),
    _span("wavefront.iteration", 2410, 2700, 5, 1, width=8, alive=2),
    _span("wavefront.wait", 2700, 2710, 5, 1, what="alive"),
    _span("render.wait", 3000, 3100, 3, 1),
    _span("train.step", 4000, 4500, request=2),
    _span("adaptive.wait", 4100, 4150, 13, 2),
]
WANT = {"mega.prepare_ms": 0.3 / 2,
        "render.host_ms": (600 + 1060) / 1e3 / 2,
        "wavefront.iterations": 1.0,
        "wavefront.lane_occupancy": 50.0,
        "wavefront.waits": 2.0,
        "adaptive.lanes_per_launch": 96.0,
        "train.host_ms": 0.45 / 2}


def _run(entry, traced=True):
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    cell = harness.cell(bench, "cornell_box.render",
                        overrides={"entry": entry})
    reading = trace.Reading(n=2, window_s=1.0, busy_s=0.5, ops=10,
                            breakdown={}) if traced else None
    return harness.Run(cell=cell, setup_s=1.0, latencies=[1.0], counts={},
                       traced=reading)


def _entry(name):
    return "train" if name.startswith("train.") else "render"


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(FAKE))
    reader = harness.load_module("metrics", name)
    assert reader.read(_run(_entry(name))) == pytest.approx(WANT[name])
    assert reader.read(_run(_entry(name), traced=False)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(_run(_entry(name))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_without_program_spans(name, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    reader = harness.load_module("metrics", name)
    assert reader.read(_run(_entry(name))) is None


def test_readers_match_a_counting_body(monkeypatch):
    """Two renders of the Perlin scene on the CPU (the wavefront, in three
    stages) inside ``recording()``, read by the readers, against a counting
    wrapper of the wavefront's loop body."""
    import torch

    from another_raytracer_tpu_torch.config import RenderConfig
    from another_raytracer_tpu_torch.models import library
    from another_raytracer_tpu_torch.ops import camera, integrator, render

    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    calls = []
    parts = integrator._regen_loop_parts

    def counting_parts(*args):
        cam_rays, body = parts(*args)

        def counted(state):
            calls.append((state[6].shape[0], int(torch.sum(state[6]))))
            return body(state)

        return cam_rays, counted

    monkeypatch.setattr(integrator, "_regen_loop_parts", counting_parts)
    scene, params = library.two_perlin_spheres(device="cpu")
    cam = camera.make_camera(aspect_ratio=1.0, device="cpu", **params)
    profiling.clear_spans()
    with profiling.recording():
        for seed in (5, 6):
            render.render(scene, cam, RenderConfig(
                width=24, height=24, samples_per_pixel=2, samples_per_pass=2,
                max_depth=8, seed=seed))
    run = _run("render")
    read = {name: harness.load_module("metrics", name).read(run)
            for name in READERS}
    profiling.clear_spans()
    assert read["wavefront.iterations"] == len(calls) / 2
    assert read["wavefront.lane_occupancy"] == pytest.approx(
        100.0 * sum(a for _, a in calls) / sum(w for w, _ in calls))
    # Per render: two reads an iteration, one a stage (three), one a
    # compaction (two).
    assert read["wavefront.waits"] == (2 * len(calls) + 2 * 5) / 2
    assert read["render.host_ms"] > 0
    assert read["mega.prepare_ms"] is None  # no card: no launch
    assert read["adaptive.lanes_per_launch"] is None


def test_program_spans_name_the_gaps_and_move_no_metric(monkeypatch):
    """The traced run hands ``trace.read`` the program's spans beside the
    benchmark's: the longest idle gaps are named by the innermost program
    span, while the window, the busy time, the device ops and every metric
    read from them stay the ``request`` spans' alone."""
    monkeypatch.setattr(profiling, "spans", lambda: list(FAKE))
    events = [("k", "kernel", s, e) for s, e in
              ((0, 100), (400, 500), (900, 1000), (2000, 2030),
               (2040, 2300), (2310, 3000), (3100, 3200))]
    ctx = harness.Context(cell=None, seed=0, device="cpu", files_dir="",
                          spans=[("request", 0, 1000),
                                 ("request", 2000, 3200)])
    spans = harness.traced_spans(ctx)
    assert spans[:2] == ctx.spans and len(spans) == 2 + len(FAKE)
    alone = trace.read(events, ctx.spans, 2)
    both = trace.read(events, spans, 2)
    for key in ("n", "window_s", "busy_s", "ops"):
        assert getattr(alone, key) == getattr(both, key)
    assert alone.breakdown["device_ops"] == both.breakdown["device_ops"]
    assert [g[1] for g in alone.breakdown["idle_gaps"]] == \
        [g[1] for g in both.breakdown["idle_gaps"]]
    assert {g[0] for g in alone.breakdown["idle_gaps"]} == \
        {"request", "between requests"}
    assert [g[0] for g in both.breakdown["idle_gaps"]][:4] == \
        ["between requests", "render.wait", "mega.prepare", "render.wait"]
    reader = harness.load_module("metrics", "device_idle.render")
    runs = [_run("render") for _ in range(2)]
    runs[0].traced, runs[1].traced = alone, both
    assert reader.read(runs[0]) == reader.read(runs[1])
