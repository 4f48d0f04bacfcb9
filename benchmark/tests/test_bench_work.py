"""The roofline arithmetic of ``benchmark/work.py``."""

import pytest

from benchmark import work


def test_readme_render_bound():
    """The README render (Cornell 720x540, spp 100, depth 50): 204,147,432
    segments over 18 rect rows, 18 x 35 + 144 = 774 operations a segment,
    bound by operations at 2.358 ms."""
    assert work.sweep_ops_per_segment(18, 0) == 774
    seconds, by = work.sweep_bound(204_147_432, 18, 0, 720, 540)
    assert by == "operations"
    assert seconds * 1e3 == pytest.approx(2.358, abs=5e-4)


def test_bound_picks_the_larger():
    assert work.bound(0, work.PEAK_BYTES) == (1.0, "bytes")
    assert work.bound(work.PEAK_OPS * 2, work.PEAK_BYTES) == (2.0,
                                                            "operations")
