"""``render_p95_ms``: the 95th percentile (nearest rank) of the latencies
of all renders of the window."""

import math


def read(run):
    if run.cell.traffic["entry"] != "render":
        return None
    ranked = sorted(run.latencies)
    return 1e3 * ranked[math.ceil(0.95 * len(ranked)) - 1]
