"""``wavefront.waits``: the host's reads of the card inside the wavefront
a traced render (``wavefront.wait`` spans: each stage's alive count, each
iteration's re-arm test, each compaction's survivors), each of which
drains the card's queue."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None or not spans_lib.named(
            spans, "wavefront"):
        return None
    return len(spans_lib.named(spans, "wavefront.wait")) / run.traced.n
