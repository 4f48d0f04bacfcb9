"""``render_ms``: the summed host time of all renders of the window over
their count."""


def read(run):
    if run.cell.traffic["entry"] != "render":
        return None
    return 1e3 * sum(run.latencies) / len(run.latencies)
