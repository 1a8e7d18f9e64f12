"""The benchmark of ``repro_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, traffic mix or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``, ``checks/<workload>.json``. The yardstick (the
traffic generator, the weights, the FLOP and byte counts, the plain
reference and the comparison that decides ``correct``) lives here; from
``repro_torch`` the harness takes only the system under test, its
counters and its kernels' names.
"""
