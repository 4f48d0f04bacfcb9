"""``train.device_ops``: device activities (kernels, copies, fills) a
traced training step."""


def read(run):
    t = run.traced
    if t is None or run.cell.traffic["entry"] != "train":
        return None
    return t.ops / t.n
