"""The benchmark of ``another_raytracer_tpu_torch`` on one NVIDIA H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Driven by data: a cell is ``workloads/<cell>.json``, which names its
configuration (``configs/<config>.json``, the scene as data) and its
traffic mix (``traffic/<traffic>.json``: the entry, the mode and the
sizes); an entry is ``entries/<entry>.py`` and a metric
``metrics/<metric>.py``.  ``BENCHMARK.json`` at the root lists them and
says which metric each cell reports.  The plain float64 reference that
decides ``correct`` is ``reference/``, which imports nothing of the
program.
"""
