"""``mega.prepare_ms``: the host's time a traced render spends building the
megakernel's launch (``mega.prepare`` spans: the row and table packing,
the camera, the buffers and the pointer tuple), ms."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    prep = spans_lib.named(spans, "mega.prepare")
    if not prep:
        return None
    return sum(s.end - s.start for s in prep) / 1e3 / run.traced.n
