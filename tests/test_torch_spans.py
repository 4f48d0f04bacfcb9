"""The port's span recorder (``utils.profiling.span``) on the render and
train paths, on the CPU at small sizes.

* Recording is off unless a ``torch.profiler`` session is active or the
  code runs inside ``profiling.recording()``; off, nothing is recorded.
* The spans of one render form a tree under its ``render`` root: every
  child inside its parent, one request id, all inside a host-clock bracket
  taken around the call.
* The wavefront's iteration spans count ``body``'s calls and carry the
  alive lanes it started from, ``graph``: ``eager`` on the CPU, and
  ``rearm``: ``ops`` or ``none`` there; ``profiling.count`` adds a count
  to the innermost open span.
* Recording changes no image and no segment count.
"""

import time

import numpy as np
import pytest
import torch

from another_raytracer_tpu_torch.config import RenderConfig, RenderMode
from another_raytracer_tpu_torch.grad import diff
from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import camera, integrator, render
from another_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 24, 24
SCENES = {"sweep": library.cornell_box,
          "wavefront": library.two_perlin_spheres}


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture
def narrow_stages(monkeypatch):
    """Stages of 1152, 256 and 128 lanes at spp 2: two compactions."""
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    assert integrator._stage_widths(W * H * 2) == [W * H * 2, 256, 128]


def _render(kind, mode=RenderMode.SINGLE, spp=2):
    scene, params = SCENES[kind](device="cpu")
    cam = camera.make_camera(aspect_ratio=W / H, device="cpu", **params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=spp,
                       samples_per_pass=spp, max_depth=8, seed=3, mode=mode)
    return render.render(scene, cam, cfg)


def _traced_render(kind, **kw):
    """A render inside ``recording()``, with the host clock just outside."""
    t0 = time.perf_counter_ns() / 1e3
    with profiling.recording():
        out = _render(kind, **kw)
    return out, profiling.spans(), (t0, time.perf_counter_ns() / 1e3)


def test_off_records_nothing(narrow_stages):
    for kind in SCENES:
        _render(kind)
    assert profiling.spans() == []
    assert profiling.span("render") is profiling.span("wavefront", lanes=1)


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_on_records_the_render(how, narrow_stages):
    if how == "recording":
        with profiling.recording():
            _render("wavefront")
    else:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            _render("wavefront")
    names = {s.name for s in profiling.spans()}
    assert names == {"render", "render.pixels", "render.wait", "wavefront",
                     "wavefront.iteration", "wavefront.wait",
                     "wavefront.compact"}
    _render("wavefront")  # off again
    assert {s.name for s in profiling.spans()} == names


@pytest.mark.parametrize("kind", list(SCENES))
def test_children_lie_in_their_parents(kind, narrow_stages):
    (_, stats), spans, _ = _traced_render(kind)
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["render"]
    # The render's counts: its segments, and through the wavefront on a
    # scene with spheres its sphere winners (test_torch_sphere_hits.py).
    hits = roots[0].attrs.pop("sphere_hits", None)
    assert (hits is None) == (kind == "sweep")
    assert hits is None or 0 < hits < stats["segments"]
    assert roots[0].attrs == {"mode": "single", "width": W, "height": H,
                              "spp": 2, "segments": stats["segments"]}
    for s in spans:
        assert s.request == roots[0].request
        assert s.start <= s.end
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start <= s.start and s.end <= up.end, (s, up)


@pytest.mark.parametrize("kind", list(SCENES))
def test_spans_lie_in_a_host_clock_bracket(kind, narrow_stages):
    _, spans, (t0, t1) = _traced_render(kind)
    assert spans and all(t0 <= s.start <= s.end <= t1 for s in spans)


def test_iterations_match_a_counting_body(narrow_stages, monkeypatch):
    calls = []  # (width, alive) at each call of body
    parts = integrator._regen_loop_parts

    def counting_parts(*args):
        cam_rays, body = parts(*args)

        def counted(state):
            calls.append((state[6].shape[0], int(state[6].sum())))
            return body(state)

        return cam_rays, counted

    monkeypatch.setattr(integrator, "_regen_loop_parts", counting_parts)
    _, spans, _ = _traced_render("wavefront")
    its = [s for s in spans if s.name == "wavefront.iteration"]
    assert [(s.attrs["width"], s.attrs["alive"]) for s in its] == calls
    assert {w for w, _ in calls} == {W * H * 2, 256, 128}
    # Each iteration waits once in body and once on its alive count; each
    # stage once more on the count that ends it, each compaction once.
    waits = [s for s in spans if s.name == "wavefront.wait"]
    assert len(waits) == 2 * len(calls) + 3 + 2
    # A compaction's survivors are the next stage's first alive lanes.
    assert [s.attrs["survivors"] for s in spans
            if s.name == "wavefront.compact"] == [
        a for (w, _), (w2, a) in zip(calls, calls[1:]) if w2 != w]


@pytest.mark.parametrize("mode", [RenderMode.SINGLE, RenderMode.ADAPTIVE])
def test_iterations_run_eagerly_on_the_cpu(mode, narrow_stages):
    """The CPU has no capture step: every iteration's ``graph`` count reads
    ``eager``, twice over the same key, and nothing is captured."""
    for _ in range(2):
        _, spans, _ = _traced_render("wavefront", mode=mode)
        profiling.clear_spans()
        its = [s for s in spans if s.name == "wavefront.iteration"]
        assert its and {s.attrs["graph"] for s in its} == {"eager"}
        assert "wavefront.capture" not in {s.name for s in spans}
    assert "cpu" not in integrator.GRAPHS


def test_count_goes_to_the_innermost_open_span():
    """``profiling.count`` adds counts to the innermost open span, and
    does nothing where no span records."""
    profiling.count(lost=1)
    with profiling.span("off"):
        profiling.count(lost=1)
    with profiling.recording():
        with profiling.span("outer", a=1):
            with profiling.span("inner"):
                pass
            profiling.count(b=2)
            with profiling.span("last"):
                profiling.count(c=3)
    assert [(s.name, s.attrs) for s in profiling.spans()] == [
        ("outer", {"a": 1, "b": 2}), ("inner", {}), ("last", {"c": 3})]


def test_iterations_count_their_rearm(narrow_stages):
    """On the CPU the eager step's body reads whether a lane re-arms: each
    iteration counts ``rearm`` "ops" (the re-arm ran) or "none", one
    ``wavefront.wait`` "regen" an iteration, and ``trace_scene`` counts
    them by kind."""
    from another_raytracer_tpu_torch import trace_scene

    scene, params = SCENES["wavefront"](device="cpu")
    cam = camera.make_camera(aspect_ratio=W / H, device="cpu", **params)
    with profiling.recording():  # two samples a lane
        render.render(scene, cam, RenderConfig(
            width=W, height=H, samples_per_pixel=4, samples_per_pass=2,
            max_depth=8, seed=3))
    spans = profiling.spans()
    its = [s for s in spans if s.name == "wavefront.iteration"]
    assert {s.attrs["rearm"] for s in its} == {"ops", "none"}
    assert len(its) == sum(s.name == "wavefront.wait"
                           and s.attrs["what"] == "regen" for s in spans)
    by_kind = trace_scene.rearm_counts(spans, 2)
    assert set(by_kind) == {"ops", "none"}
    assert sum(by_kind.values()) == len(its) / 2


@pytest.mark.parametrize("kind,mode", [
    ("wavefront", RenderMode.SINGLE), ("sweep", RenderMode.SINGLE),
    ("wavefront", RenderMode.ADAPTIVE)])
def test_recording_changes_no_result(kind, mode, narrow_stages):
    img, stats = _render(kind, mode=mode)
    (img_on, stats_on), spans, _ = _traced_render(kind, mode=mode)
    np.testing.assert_array_equal(img, img_on)
    assert stats == stats_on
    if mode == RenderMode.ADAPTIVE:
        levels = [s for s in spans if s.name == "adaptive.level"]
        assert len(levels) == stats["batches"]
        assert sum(s.attrs["lanes"] for s in levels) == \
            2 * stats["traced_pixels"]
        assert all(spans[s.parent].name == "adaptive.level"
                   for s in spans if s.name == "adaptive.wait")


def test_train_step_records_its_phases():
    scene, params = library.cornell_box(device="cpu")
    cam = camera.make_camera(aspect_ratio=1.0, device="cpu", **params)
    target = torch.full((8 * 8, 3), 0.5)
    state, step = diff.make_train_step(scene, cam, target, width=8, height=8,
                                       spp=2, samples_per_pass=2, max_depth=3)
    with profiling.recording():
        step(state, 1)
    spans = profiling.spans()
    root = spans[0]
    assert root.name == "train.step" and root.parent == -1
    children = [s.name for s in spans if s.parent == 0]
    assert children == ["train.forward", "train.backward", "train.adam"]
    assert all(s.request == root.request for s in spans)
    assert sum(s.parent == -1 for s in spans) == 1


def test_profiling_trace_drops_its_spans(tmp_path):
    """``profiling.trace`` turns recording on and drops the spans of its
    region at the end; a reader inside the region sees them."""
    with profiling.recording():
        with profiling.span("before"):
            pass
    with profiling.trace(str(tmp_path)):
        _render("sweep")
        inside = {s.name for s in profiling.spans()}
    assert {"before", "render", "render.wait"} <= inside
    assert [s.name for s in profiling.spans()] == ["before"]


def _span(name, start, end, parent=-1):
    return profiling.Span(name, start, end, parent, 0, {})


def test_trace_scene_idle_by_innermost_span():
    """``trace_scene.span_table`` on spans and device events on the host's
    clock: each gap goes to the innermost span open at its middle."""
    from another_raytracer_tpu_torch import trace_scene

    spans = [_span("render", 0.0, 100.0), _span("mega.prepare", 0.0, 30.0, 0),
             _span("mega.launch", 30.0, 32.0, 0),
             _span("render.wait", 60.0, 100.0, 0)]
    events = [{"name": "pack", "ts": 10.0, "dur": 5.0},
              {"name": "K1", "ts": 34.0, "dur": 56.0},
              {"name": "copy", "ts": 95.0, "dur": 10.0}]
    t = trace_scene.span_table(spans, 2, events, bare=spans[:1])
    # gaps: 0-10 prepare, 15-34 (middle 24.5) prepare, 90-95 wait
    idle = {k: v["idle_ms"] for k, v in t["spans"].items()}
    assert idle["mega.prepare"] == pytest.approx((10 + 19) / 1e3 / 2)
    assert idle["render.wait"] == pytest.approx(5 / 1e3 / 2)
    assert idle["render"] is None and idle["mega.launch"] is None
    assert t["idle_ms"] == pytest.approx(34 / 1e3 / 2)
    assert [g[0] for g in t["gaps"]] == ["mega.prepare", "mega.prepare",
                                         "render.wait"]
    assert t["spans"]["render"]["calls"] == 0.5
    assert t["spans"]["render"]["bare_ms"] == pytest.approx(0.05)
    assert t["spans"]["mega.prepare"]["bare_ms"] is None
    # a gap while no span is open
    t = trace_scene.span_table(
        [_span("render", 0.0, 10.0), _span("render", 20.0, 30.0)], 2,
        [{"name": "K1", "ts": 0.0, "dur": 10.0},
         {"name": "K1", "ts": 22.0, "dur": 6.0}])
    assert t["gaps"] == [(trace_scene.OUTSIDE, pytest.approx(0.012)),
                         ("render", pytest.approx(0.002))]


def test_trace_scene_on_host_clock():
    from another_raytracer_tpu_torch import trace_scene

    events = [{"name": "warm", "ts": 990.0, "dur": 1.0},
              {"name": "spin_kernel(long)", "ts": 1000.0, "dur": 1.0},
              {"name": "K1", "ts": 1010.0, "dur": 5.0}]
    assert trace_scene.on_host_clock(events, 50.0) == [
        {"name": "K1", "ts": 60.0, "dur": 5.0}]


@pytest.mark.parametrize("row, names", [
    ("cornell", {"render", "render.pixels", "render.wait"}),
    ("metal_diel_grad", {"train.step", "train.forward", "train.backward",
                         "train.adam"})])
def test_trace_scene_entry_spans_on_the_cpu(row, names, capsys):
    """``trace_scene --entry`` reads the spans of the port's entry points:
    calls and host ms a run, traced and without a profiler."""
    from another_raytracer_tpu_torch import trace_scene

    s = trace_scene.trace(row, "cpu", size=(24, 12, 2, 3), entry=True)
    assert names <= set(s["spans"])
    for name in names:
        row_ = s["spans"][name]
        assert row_["calls"] >= 1 and row_["ms"] > 0 and row_["bare_ms"] > 0
        assert row_["idle_ms"] is None
    assert s["gaps"] is None and profiling.spans() == []
    trace_scene.report(s)
    assert "train.adam" in capsys.readouterr().out or row == "cornell"
