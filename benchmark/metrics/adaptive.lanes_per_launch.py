"""``adaptive.lanes_per_launch``: the mean lanes of the adaptive mode's
level batches (``adaptive.level`` spans) in the traced renders."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    levels = spans_lib.named(spans, "adaptive.level")
    if not levels:
        return None
    return sum(s.attrs["lanes"] for s in levels) / len(levels)
