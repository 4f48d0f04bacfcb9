"""``render.segments_per_sample``: the ray segments of a traced render (the
``render`` span's ``segments`` count) over its width x height x spp,
averaged over the traced renders: a path's mean length in segments, which
paths trapped inside a sphere lengthen.  Nothing where the program's
``render`` span counts no segments (a tree from before it did)."""

from benchmark import spans as spans_lib


def read(run):
    spans = spans_lib.recorded()
    tr = run.cell.traffic
    if run.traced is None or spans is None or tr["entry"] != "render":
        return None
    counts = [s.attrs["segments"] for s in spans
              if s.parent < 0 and s.name == "render" and "segments" in s.attrs]
    if not counts:
        return None
    samples = tr["width"] * tr["height"] * tr["spp"]
    return sum(counts) / len(counts) / samples
