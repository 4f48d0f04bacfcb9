"""``accel_roofline``: the least time of the traced renders of scene 1 at
the card's peaks (the work frozen in the metric's file) over the device's
busy time, in %, on synthetic runs; None where the run was not traced or
the scene holds what the frozen work does not count."""

import json

import pytest

from benchmark import harness, trace, work

W, H, SPP = 12, 12, 2  # the traffic's sizes, overridden
SPHERES = {"rects": 0, "spheres": 871, "triangles": 0, "media": 0}


def _reader():
    return harness.load_module("metrics", "accel_roofline")


def _run(segments=(1000, 3000), busy_s=0.5, counts=SPHERES, traced=True,
         cell="random.render"):
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    c = harness.cell(bench, cell, overrides={"width": W, "height": H,
                                             "spp": SPP})
    reading = trace.Reading(n=len(segments), window_s=1.0, busy_s=busy_s,
                            ops=10, breakdown={}) if traced else None
    return harness.Run(cell=c, setup_s=1.0, latencies=[1.0], counts=counts,
                       traced=reading,
                       traced_records=[{"segments": s} for s in segments])


def test_the_frozen_work():
    """Scene 1's segment: the sweep's rest, the re-projected winner, and
    the walk's tests at their per-segment counts; the bytes K3's tables at
    leaf 16 (46,064 B, the walk's shared memory) and the image's sums."""
    m = _reader()
    assert m.TABLE_BYTES == 46_064
    assert (m.OPS_SLAB, m.OPS_SPHERE) == (25, 39)
    assert m.ops_per_segment() == pytest.approx(
        work.OPS_SEGMENT + m.OPS_WINNER + 25 * m.SLABS_PER_SEGMENT
        + 39 * m.SPHERES_PER_SEGMENT)


def test_least_time_over_busy_time():
    m = _reader()
    ops = m.ops_per_segment()
    nbytes = W * H * work.PIXEL_BYTES + m.TABLE_BYTES
    least = sum(work.bound(s * ops, nbytes)[0] for s in (1000, 3000))
    assert m.read(_run()) == pytest.approx(100.0 * least / 0.5)
    # Twice the busy time, half the share.
    assert m.read(_run(busy_s=1.0)) == pytest.approx(50.0 * least / 0.5)


def test_bound_by_operations_at_the_cell_s_size():
    """At the cell's 720 x 540, spp 100, ~3 segments a sample, the walk's
    operations and not its bytes bound the render."""
    m = _reader()
    segments = 3 * 720 * 540 * 100
    assert work.bound(segments * m.ops_per_segment(),
                      720 * 540 * work.PIXEL_BYTES + m.TABLE_BYTES)[1] \
        == "operations"


@pytest.mark.parametrize("counts", [
    dict(SPHERES, rects=18), dict(SPHERES, triangles=96),
    dict(SPHERES, media=1), dict(SPHERES, spheres=0)])
def test_nothing_to_read_where_the_work_is_another(counts):
    assert _reader().read(_run(counts=counts)) is None


def test_nothing_to_read_untraced():
    assert _reader().read(_run(traced=False)) is None


def test_only_in_its_cell():
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    entry = [m for m in bench["per_layer"] if m["name"] == "accel_roofline"]
    assert entry[0]["workloads"] == ["random.render"]
    assert entry[0]["unit"] == "%" and entry[0]["moves"] == "render_ms"
    for cell in ("cornell_box.render", "final_scene.render"):
        names = [m["name"] for m in harness.cell(bench, cell).per_layer]
        assert "accel_roofline" not in names
