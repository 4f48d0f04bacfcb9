"""The program's spans, as the per-layer metrics read them.

The port records a span at each layer boundary of a render or a training
step (``another_raytracer_tpu_torch.utils.profiling.span``) while a
``torch.profiler`` session is active, so in a traced run it records the
traced requests alone.  ``recorded()`` is None where the program records no
spans (a tree from before it did): a metric that reads them then reads
nothing."""

from __future__ import annotations

import collections

WAIT = ".wait"  # the suffix of a span in which the host waits on the card


def recorded():
    """The program's recorded spans (name, start and end in us, parent
    index, request id, attrs), or None where it records none."""
    from another_raytracer_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def named(spans, name) -> list:
    return [s for s in spans if s.name == name]


def host_us(spans, root: str):
    """The summed time of the root spans named ``root`` less the time of
    their outermost ``*.wait`` descendants, in us; None where there is no
    such root."""
    waits = collections.defaultdict(float)  # request id -> us
    for s in spans:
        if s.name.endswith(WAIT):
            p = s.parent
            while p >= 0 and not spans[p].name.endswith(WAIT):
                p = spans[p].parent
            if p < 0:
                waits[s.request] += s.end - s.start
    roots = [s for s in spans if s.parent < 0 and s.name == root]
    if not roots:
        return None
    return sum(s.end - s.start - waits[s.request] for s in roots)
