"""The regenerating wavefront's graph path (``integrator._Stage``) on the
CPU, with the capture step injected: a capture that records nothing and
whose replay runs the captured function again, so the buffers, the
compaction's copies, the seed buffer, the capture rule and the cache run as
on the card.  The card's own graphs are tested in ``test_torch_cuda.py``.

* The graph path gives the eager path's images and segments bit for bit:
  on the render that captures, on a render with another seed that replays,
  after an eviction, across every compaction stage; what it returns does
  not alias a buffer.
* A key's first iteration runs eagerly, its second captures (graphs A and
  B), every later one replays; a stage that ends after one iteration never
  captures.  The cache keeps ``GRAPH_CACHE_SIZE`` stages.
* A replay adds the launches its graph holds to the kernels' counts, under
  any name; a stage's key holds the tree K5 folds at its width.
* A step that re-arms its lanes itself (the bounce kernel's contract, here
  the eager step composed with its re-arm) gives the same bits and
  iterations with one read of the card an iteration and no graph B.
"""

import collections

import pytest
import torch

from another_raytracer_tpu_torch.models import library
from another_raytracer_tpu_torch.ops import (camera, integrator, intersect,
                                            kernels, render)
from another_raytracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 24, 24


class FakeGraphs:
    """The capture step for the CPU: counts its captures; the replay is the
    captured function itself."""

    def __init__(self):
        self.captures = 0

    def __call__(self, device):
        assert device.type == "cpu"

        def capture(fn):
            self.captures += 1
            return fn

        return capture


@pytest.fixture
def graphs(monkeypatch):
    """The graph path on the CPU over an empty cache; stages of 1152, 256
    and 128 lanes."""
    fake = FakeGraphs()
    monkeypatch.setitem(integrator.GRAPHS, "cpu", fake)
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    assert integrator._stage_widths(W * H * 2) == [W * H * 2, 256, 128]
    profiling.clear_spans()
    yield fake
    profiling.clear_spans()


def _scene(name):
    scene, params = getattr(library, name)(device="cpu")
    return scene, camera.make_camera(aspect_ratio=W / H, device="cpu",
                                     **params)


def _radiance(scene, cam, seed, n_samples=4, spass=2, max_depth=8,
              pixels=W * H):
    """Radiance sums and segments over ``pixels`` pixels, with the
    ``graph`` count of each iteration span as (width, graph)."""
    profiling.clear_spans()
    with profiling.recording():
        acc, segs = render.radiance_batch(
            scene, cam, torch.arange(pixels), seed, width=W, height=H,
            sample_start=0, n_samples=n_samples, spp_cap=n_samples,
            samples_per_pass=spass, max_depth=max_depth, t_min=1e-3)
    modes = [(s.attrs["width"], s.attrs["graph"]) for s in profiling.spans()
             if s.name == "wavefront.iteration"]
    profiling.clear_spans()
    return torch.stack(tuple(acc)), int(segs), modes


def _assert_captured_anew(modes):
    """Each stage of a new key: eager, capture, then replays."""
    for w in {w for w, _ in modes}:
        seq = [m for v, m in modes if v == w]
        assert seq[:2] == ["eager", "capture"][:len(seq)], (w, seq)
        assert set(seq[2:]) <= {"replay"}


def _eager(scene, cam, seed, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.delitem(integrator.GRAPHS, "cpu")
        return _radiance(scene, cam, seed, **kw)


@pytest.mark.parametrize("name", ["two_perlin_spheres", "cornell_smoke"])
def test_graph_path_equals_eager(name, graphs, monkeypatch):
    scene, cam = _scene(name)
    want = {seed: _eager(scene, cam, seed, monkeypatch) for seed in (5, 6)}
    assert all(m == "eager" for _, _, modes in want.values()
               for _, m in modes)

    first = _radiance(scene, cam, 5)  # captures
    widths = {w for w, _ in first[2]}
    assert W * H * 2 in widths and len(widths) >= 2  # a compaction or two
    _assert_captured_anew(first[2])
    kept = first[0].clone()
    second = _radiance(scene, cam, 6)  # replays with another seed
    third = _radiance(scene, cam, 5)
    for got, seed in ((first, 5), (second, 6), (third, 5)):
        assert torch.equal(got[0], want[seed][0]) and got[1] == want[seed][1]
    assert {m for _, m in third[2]} == {"replay"}
    # Nothing returned aliases a buffer that a later render overwrites.
    assert torch.equal(first[0], kept)
    assert graphs.captures == 2 * len(widths)

    # A cache of one stage: each stage evicts the last, and captures again.
    monkeypatch.setattr(integrator, "GRAPH_CACHE_SIZE", 1)
    integrator._stages.clear()
    for seed in (6, 5):
        got = _radiance(scene, cam, seed)
        assert torch.equal(got[0], want[seed][0]) and got[1] == want[seed][1]
        _assert_captured_anew(got[2])
    assert len(integrator._stages) == 1


def test_graph_path_equals_eager_adaptive(graphs, monkeypatch):
    """The adaptive mode over the graph path: one key per level's width."""
    from another_raytracer_tpu_torch.config import RenderConfig, RenderMode

    scene, cam = _scene("two_perlin_spheres")
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4,
                       samples_per_pass=2, max_depth=8, seed=3,
                       mode=RenderMode.ADAPTIVE)
    with monkeypatch.context() as m:
        m.delitem(integrator.GRAPHS, "cpu")
        want_img, want_stats = render.render(scene, cam, cfg)
    for _ in range(2):
        img, stats = render.render(scene, cam, cfg)
        assert (img == want_img).all() and stats == want_stats
    assert graphs.captures > 0


def test_one_iteration_never_captures(graphs, monkeypatch):
    """Depth 1 and one sample: every path ends in the first iteration, so
    the render's one stage never captures; the key's next render captures
    at its first iteration and the one after replays."""
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1 << 20)
    scene, cam = _scene("two_perlin_spheres")
    kw = dict(n_samples=1, spass=1, max_depth=1)
    want = _eager(scene, cam, 4, monkeypatch, **kw)
    for mode, captures in (("eager", 0), ("capture", 2), ("replay", 2)):
        got = _radiance(scene, cam, 4, **kw)
        assert got[2] == [(W * H, mode)]
        assert graphs.captures == captures
        assert torch.equal(got[0], want[0]) and got[1] == want[1]


def test_cache_keeps_the_newest_stages(graphs, monkeypatch):
    """One stage a width; a cache of two keeps the two used last, and a
    width it dropped starts eager again."""
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 1 << 20)
    monkeypatch.setattr(integrator, "GRAPH_CACHE_SIZE", 2)
    scene, cam = _scene("two_perlin_spheres")

    def first_mode(pixels):
        return _radiance(scene, cam, 2, pixels=pixels)[2][0][1]

    assert [first_mode(p) for p in (64, 96, 64)] == ["eager"] * 2 + ["replay"]
    # A stage's width: two lanes a pixel.
    assert [k[3] for k in integrator._stages] == [192, 128]
    assert first_mode(128) == "eager"  # evicts 96
    assert [k[3] for k in integrator._stages] == [128, 256]
    assert first_mode(96) == "eager"
    assert first_mode(64) == "eager"


def _capture_runs_python(fn):
    """A graph's capture: it runs the Python (whose wrappers count), not the
    card; its replay gives what the body returned."""
    out = fn()
    return lambda: out


def test_replay_adds_the_graphs_launches(monkeypatch):
    """At capture the kernels' wrappers count launches that do not run; the
    registry returns to what it was, and each replay adds them."""
    monkeypatch.setattr(kernels, "COUNTS", collections.Counter(
        {"K5/rect/shared": 3, "K4": 1, "K4.points": 10}))

    def body():  # what the wrappers count when the body runs
        kernels.count("K5/planar/global")
        kernels.count("K5/rect/shared", 2)
        kernels.count("K4")
        kernels.count("K4.points", 100)
        return "out"

    replays = []

    def capture(fn):
        fn()
        return lambda: replays.append(1) or "out"

    replay = integrator._counted(capture, body)
    assert kernels.COUNTS == {"K5/rect/shared": 3, "K4": 1, "K4.points": 10}
    assert replay() == replay() == "out" and len(replays) == 2
    assert kernels.COUNTS == {"K5/rect/shared": 7, "K5/planar/global": 2,
                              "K4": 3, "K4.points": 210}
    counts = kernels.launch_counts()
    assert counts["K5_by_tree"] == {"rect/shared": 7, "planar/global": 2}
    assert (counts["K5"], counts["K4"]) == (9, 3)


def test_replay_adds_the_graphs_draw_launches(monkeypatch):
    """The draws kernel's launches a graph holds: restored after the capture,
    added by each replay, and kept on the replay as ``held``, keyed as
    ``launch_counts`` keys them."""
    monkeypatch.setattr(kernels, "COUNTS", collections.Counter({"draws": 5}))

    def body():
        kernels.count("draws", 4)
        return "out"

    replay = integrator._counted(_capture_runs_python, body)
    assert kernels.COUNTS == {"draws": 5}
    assert replay.held == {**kernels.launch_counts(collections.Counter()),
                           "draws": 4}
    replay()
    replay()
    assert kernels.launch_counts()["draws"] == 13


def test_replay_adds_a_kernel_the_wavefront_never_names(monkeypatch):
    """A kernel that the loop body counts under a name nothing else knows:
    restored after the capture, re-added by each replay, in ``held`` and in
    ``launch_counts`` beside the others."""
    monkeypatch.setattr(kernels, "COUNTS", collections.Counter({"K1": 2}))

    def body():
        kernels.count("W9_new")
        kernels.count("W9_new", 2)
        return "out"

    replay = integrator._counted(_capture_runs_python, body)
    assert kernels.COUNTS == {"K1": 2}
    assert "W9_new" not in kernels.launch_counts()
    assert replay.held["W9_new"] == 3 and replay.held["K1"] == 0
    replay()
    replay()
    counts = kernels.launch_counts()
    assert (counts["W9_new"], counts["K1"]) == (6, 2)


def test_stage_key_holds_the_fold(monkeypatch):
    """A stage is keyed by the tree K5 folds at its width: a gate moved
    across the width gives the stage a new key (its graphs would hold the
    other variant), a gate moved on the same side keeps it."""
    monkeypatch.setitem(integrator.GRAPHS, "cpu", FakeGraphs())
    monkeypatch.setattr(integrator, "_stages", collections.OrderedDict())
    scene, cam = _scene("random_scene")
    parts_args = (scene, cam, W, H, 1, 4, 8, 1e-3)
    dev = torch.device("cpu")
    width = 4096
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", width)
    folded = integrator._stage(dev, width, parts_args)
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", 1)
    assert integrator._stage(dev, width, parts_args) is folded
    monkeypatch.setattr(intersect, "FOLD_SPH_MIN_B", width + 1)
    unfolded = integrator._stage(dev, width, parts_args)
    assert unfolded is not folded
    assert [k[-1] for k in integrator._stages] == ["sphere", None]


def _rearming_parts(*args):
    """The eager step composed with its re-arm, marked as a step that
    re-arms its lanes: the bounce kernel's contract on the CPU."""
    cam_rays, step, rearm = integrator._eager_step_parts(*args)

    def rearming(state, into=None):
        new, regen, _ = step(state)
        return rearm(new, regen), None, None

    rearming.kind, rearming.rearms = "eager", True
    return cam_rays, rearming, None


def _recorded(scene, cam, seed):
    """Radiance sums, segments and the spans of a render of two samples a
    pixel over ``W * H`` pixels, in three stages."""
    profiling.clear_spans()
    with profiling.recording():
        acc, segs = render.radiance_batch(
            scene, cam, torch.arange(W * H), seed, width=W, height=H,
            sample_start=0, n_samples=4, spp_cap=4, samples_per_pass=2,
            max_depth=8, t_min=1e-3)
    spans = profiling.spans()
    profiling.clear_spans()
    return torch.stack(tuple(acc)), int(segs), spans


def _reads(spans):
    """(iteration spans, the ``wavefront.wait`` spans less one a stage and
    one a compaction: the reads the loop bodies made)."""
    its = [s for s in spans if s.name == "wavefront.iteration"]
    stages = sum(s.attrs["stages"] for s in spans if s.name == "wavefront")
    compactions = sum(s.name == "wavefront.compact" for s in spans)
    assert stages == 3 and compactions == 2
    waits = sum(s.name == "wavefront.wait" for s in spans)
    return its, waits - stages - compactions


@pytest.mark.parametrize("with_graphs", [True, False])
def test_a_step_that_rearms_reads_once_an_iteration(with_graphs, graphs,
                                                    monkeypatch):
    """The eager loop against the same loop whose step re-arms its lanes
    (``step.rearms``), with the graph path or without: the same radiance
    and segments bit for bit, the same iterations and widths, one
    ``wavefront.wait`` fewer an iteration and no graph B; each iteration
    counts ``rearm``: "kernel" where the step re-armed, else "ops" where
    the host read that a lane re-arms and "none" where it read none."""
    if not with_graphs:
        monkeypatch.delitem(integrator.GRAPHS, "cpu")
    scene, cam = _scene("two_perlin_spheres")
    runs = {}
    for rearms in (False, True):
        with monkeypatch.context() as m:
            if rearms:
                m.setattr(integrator, "_regen_step_parts", _rearming_parts)
            m.setattr(integrator, "_stages", collections.OrderedDict())
            captures = graphs.captures
            runs[rearms] = [_recorded(scene, cam, seed) for seed in (5, 6)]
            runs[rearms] += [graphs.captures - captures,
                             list(integrator._stages.values())]
    *want, want_captures, want_stages = runs[False]
    *got, got_captures, got_stages = runs[True]
    for (img, segs, spans), (w_img, w_segs, w_spans) in zip(got, want):
        assert torch.equal(img, w_img) and segs == w_segs
        its, reads = _reads(spans)
        w_its, w_reads = _reads(w_spans)
        assert ([(s.attrs["width"], s.attrs["alive"]) for s in its]
                == [(s.attrs["width"], s.attrs["alive"]) for s in w_its])
        assert reads == len(its) and w_reads == 2 * len(w_its)
        assert {s.attrs["rearm"] for s in its} == {"kernel"}
        assert {s.attrs["rearm"] for s in w_its} == {"ops", "none"}
    if with_graphs:
        # Graph A a stage where the step re-arms; A and B otherwise.
        assert 2 * got_captures == want_captures == 2 * 3
        assert len(got_stages) == len(want_stages) == 3
        assert all(st.rearm is None for st in got_stages)
        assert all(st.rearm is not None for st in want_stages)
        assert {s.attrs["what"] for _, _, spans in got for s in spans
                if s.name == "wavefront.capture"} == {"step"}
    else:
        assert got_captures == want_captures == 0
        assert not got_stages and not want_stages
