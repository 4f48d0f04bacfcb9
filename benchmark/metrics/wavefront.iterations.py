"""``wavefront.iterations``: the wavefront's loop iterations a traced
render (``wavefront.iteration`` spans), each one pass of the host's op
stream over a stage's lanes."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    its = spans_lib.named(spans, "wavefront.iteration")
    return len(its) / run.traced.n if its else None
