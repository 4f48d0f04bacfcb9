"""``step_ms``: the summed host time of all training steps of the window
(forward, backward, adam, the loss read on the host) over their count."""


def read(run):
    if run.cell.traffic["entry"] != "train":
        return None
    return 1e3 * sum(run.latencies) / len(run.latencies)
