"""``wavefront.bounce_share``: the share of the wavefront's loop iterations
of the traced renders (``wavefront.iteration`` spans) whose step ran the
bounce kernel (``step`` == ``kernel``) rather than the eager step, in
percent.  None where the program's iterations carry no ``step`` count (a
tree from before they did)."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    its = spans_lib.named(spans, "wavefront.iteration")
    if not its or any("step" not in s.attrs for s in its):
        return None
    kernel = sum(s.attrs["step"] == "kernel" for s in its)
    return 100.0 * kernel / len(its)
