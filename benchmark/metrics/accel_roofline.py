"""``accel_roofline``: the least time of a render of the configuration
``random`` (scene 1: one tree of 871 spheres, walked by K3, the accel
instance of the megakernel) at the card's peaks over the device's busy
time a traced render, in percent, as ``sweep_roofline`` reads K1's.

The work is frozen here, so that no change to the program moves the
yardstick.  A segment of that render needs:

  * ``work.OPS_SEGMENT``: the rest of a segment, as the sweep counts it;
  * ``OPS_WINNER``: the winner's point and normal re-projected onto its
    sphere, counted from ``csrc/mega_kernel.cu`` (``accel_hit``'s tail and
    ``onto_sphere``): the centre at the ray's time 8, 1/r 2, o + t d 6, the
    offset 3, the range test 6, |off|^2 5, its test 1, |r| / |off| 3, the
    rescaled offset 3, the normal 3, the point 6;
  * the walk's slab tests at ``OPS_SLAB`` and sphere tests at
    ``OPS_SPHERE`` (``ops/bvh.py``'s ``OPS_PER_SLAB`` and
    ``OPS_PER_TEST["sphere", False]``, copied as numbers), as many a
    segment as ``SLABS_PER_SEGMENT`` and ``SPHERES_PER_SEGMENT``: what
    ``mega_kernel.walk_tallies`` counted once, on an H100, on the cell's
    request 0 of seed 3,000,000,001 (720 x 540, spp 100, depth 50, the
    configuration's tree at leaf 16).

The bytes are the image's sums and K3's compact tables of that tree (109
nodes of 32 B, 887 leaf rows of 48 B).  Counted from the segments of the
traced renders, so it reads None outside a render, or where the cell's
scene holds rects, triangles or media, whose work this does not count."""

from benchmark import work

OPS_WINNER = 46
OPS_SLAB, OPS_SPHERE = 25, 39
# 3,245,308,214 slab and 6,631,912,772 sphere tests over 115,474,089
# segments (NVIDIA H100 80GB HBM3, 700 W).
SLABS_PER_SEGMENT = 28.104
SPHERES_PER_SEGMENT = 57.432
TABLE_BYTES = 109 * 32 + 887 * 48


def ops_per_segment() -> float:
    return (work.OPS_SEGMENT + OPS_WINNER + SLABS_PER_SEGMENT * OPS_SLAB
            + SPHERES_PER_SEGMENT * OPS_SPHERE)


def read(run):
    c, t = run.counts, run.traced
    if (t is None or run.cell.traffic["entry"] != "render" or c["rects"]
            or c["triangles"] or c["media"] or not c["spheres"]):
        return None
    tr = run.cell.traffic
    nbytes = tr["width"] * tr["height"] * work.PIXEL_BYTES + TABLE_BYTES
    least = sum(work.bound(r["segments"] * ops_per_segment(), nbytes)[0]
                for r in run.traced_records)
    return 100.0 * least / t.busy_s
