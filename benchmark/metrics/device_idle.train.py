"""``device_idle.train``: the share of the traced steps' wall in which the
card ran no kernel, copy or fill, in percent."""


def read(run):
    t = run.traced
    if t is None or run.cell.traffic["entry"] != "train":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
