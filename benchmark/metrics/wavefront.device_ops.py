"""``wavefront.device_ops``: device activities (kernels, copies, fills) a
traced render, where the render runs the wavefront (a scene with
triangles or media, which the megakernel does not take): the host's op
stream."""


def read(run):
    t, c = run.traced, run.counts
    if (t is None or run.cell.traffic["entry"] != "render"
            or not (c["triangles"] or c["media"])):
        return None
    return t.ops / t.n
