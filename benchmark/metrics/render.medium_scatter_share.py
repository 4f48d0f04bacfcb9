"""``render.medium_scatter_share``: of the ray segments of the traced
renders (the ``render`` span's ``segments`` counts), the share whose closest
hit is a medium, each a scatter in it (its ``medium_scatters`` counts), in
%.  Denser or larger media raise it, and with it the segments a sample.
Nothing where the run is untraced, where the program records no spans, or
where no ``render`` span counts medium scatters (a scene without media, or
a tree from before the port counted them): every attribute is looked for
before it is read."""

from benchmark import spans as spans_lib


def _counts(span):
    """(medium scatters, segments) of a ``render`` root span that counts
    both, else None."""
    attrs = getattr(span, "attrs", None)
    if (getattr(span, "name", None) != "render"
            or getattr(span, "parent", 0) >= 0 or not isinstance(attrs, dict)
            or "medium_scatters" not in attrs or not attrs.get("segments")):
        return None
    return attrs["medium_scatters"], attrs["segments"]


def read(run):
    if getattr(run, "traced", None) is None:
        return None
    spans = spans_lib.recorded()
    if not spans:
        return None
    counts = [c for c in map(_counts, spans) if c is not None]
    if not counts:
        return None
    return 100.0 * sum(m for m, _ in counts) / sum(s for _, s in counts)
