"""``wavefront.lane_occupancy``: the alive lanes over the stage's lanes,
summed over the wavefront's loop iterations of the traced renders
(``wavefront.iteration`` spans), in percent: the share of the op stream's
lanes that carry a path."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    its = spans_lib.named(spans, "wavefront.iteration")
    if not its:
        return None
    return (100.0 * sum(s.attrs["alive"] for s in its)
            / sum(s.attrs["width"] for s in its))
