"""``sweep_roofline``: the least time of a sweep render at the card's peaks
(``work.sweep_bound`` of its segments, every segment testing every row)
over the device's busy time a traced render, in percent.  Counted from the
scene and the segments, not from launches, so it reads the same work
whatever kernel implements the render.  Nothing to read in a scene the
sweep does not take (triangles, media)."""

from benchmark import work


def read(run):
    c, t = run.counts, run.traced
    if (t is None or run.cell.traffic["entry"] != "render"
            or c["triangles"] or c["media"]):
        return None
    tr = run.cell.traffic
    least = sum(work.sweep_bound(r["segments"], c["rects"], c["spheres"],
                                 tr["width"], tr["height"])[0]
                for r in run.traced_records)
    return 100.0 * least / t.busy_s
