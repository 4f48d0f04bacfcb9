"""The hand-written CUDA kernels and their wrappers.

Every launch is counted in one registry, ``COUNTS``: each wrapper calls
``count`` where it launches its kernel, and nowhere else (a CPU tensor takes
the plain version and counts nothing).  ``launch_counts`` reads it and
``reset_launch_counts`` clears it.
"""

import collections

# name -> count.  A name is a kernel's launches ("K1", "draws"), its
# launches on one part, "<kernel>/<part>" (K5's tree and table route,
# "K5/sphere/shared"), or another count kept beside them, "<kernel>.<what>"
# (K4's points, "K4.points").
COUNTS = collections.Counter()

# What ``launch_counts`` gives before any launch, in its order: the sweep's
# forward (K1) and record (K2) instances, K3's forward and record instances
# on tables in shared and in device memory, the replay, K5 and its launches
# by part, K4, the draws kernel and the bounce kernel.
KEYS = ("K1", "K2", "K3", "K3_record", "K3_global", "K3_record_global",
        "replay", "K5", "K5_by_tree", "K4", "draws", "bounce")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name``'s count in ``COUNTS``."""
    COUNTS[name] += n


def launch_counts(counts=None) -> dict:
    """{kernel: launches} of ``counts`` (a Counter of ``COUNTS``' names,
    default ``COUNTS``): ``KEYS`` and any other kernel counted, each
    kernel's parts summed into it and given by part as ``<kernel>_by_tree``;
    the other counts left out."""
    counts = COUNTS if counts is None else counts
    out = dict.fromkeys(KEYS, 0)
    out["K5_by_tree"] = {}
    for name, n in counts.items():
        kernel, _, part = name.partition("/")
        if "." not in kernel:
            out[kernel] = out.get(kernel, 0) + n
            if part:
                out.setdefault(f"{kernel}_by_tree", {})[part] = n
    return out


def reset_launch_counts() -> None:
    """Every count to 0."""
    COUNTS.clear()
