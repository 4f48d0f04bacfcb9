"""``render.host_ms``: the host's time a traced render in which it does not
wait on the card (the ``render`` span less its ``*.wait`` spans), ms."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if (run.traced is None or spans is None
            or run.cell.traffic["entry"] != "render"):
        return None
    us = spans_lib.host_us(spans, "render")
    return None if us is None else us / 1e3 / run.traced.n
