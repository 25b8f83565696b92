"""gpubench: the benchmark of ``evam_tpu_torch`` on an NVIDIA GPU.

``python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything a cell needs is
found by name: its configuration in ``configs/``, its traffic mix in
``traffic/``, the engine it builds in ``engines/``, the comparison that
decides ``correct`` in ``judges/``, the plain reference in
``reference/`` and each per-layer metric's reader in ``metrics/``.
"""
