"""``wavefront.graph_share``: the share of the wavefront's loop iterations
of the traced renders (``wavefront.iteration`` spans) that replayed the
stage's CUDA graphs (``graph`` == ``replay``) rather than running the body
eagerly or capturing it, in percent.  None where the program's iterations
carry no ``graph`` count (a tree from before it did)."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    if run.traced is None or spans is None:
        return None
    its = spans_lib.named(spans, "wavefront.iteration")
    if not its or any("graph" not in s.attrs for s in its):
        return None
    replays = sum(s.attrs["graph"] == "replay" for s in its)
    return 100.0 * replays / len(its)
