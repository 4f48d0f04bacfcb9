"""The benchmark's command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine whose card the cell asks for.
The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number and its limit,
which also close standard error).  Exits 2 without a result where no card
is visible or a name is unknown, 3 where the run loaded JAX.
"""

import time

STARTED = time.perf_counter()

import sys  # noqa: E402


def main() -> int:
    from benchmark import harness

    return harness.main(sys.argv[1:], STARTED)


if __name__ == "__main__":
    sys.exit(main())
