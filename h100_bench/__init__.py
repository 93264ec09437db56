"""The benchmark of ``fetalsyngen_torch`` on one NVIDIA H100.

``python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root runs one cell of
``BENCHMARK.json`` and prints its result as the last line of standard
output. Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``checks/<cell>.json``, ``metrics/<metric>.py``
and ``spans/<span>.json``.
"""
