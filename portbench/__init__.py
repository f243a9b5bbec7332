"""Benchmark of the PyTorch and CUDA port on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Configurations,
traffic mixes, per-cell limits and per-layer metrics are files under
``configs/``, ``traffic/``, ``limits/`` and ``metrics/``, found by the
names in ``BENCHMARK.json``.  ``harness/`` and ``reference/`` are the
yardstick: the case generator, the spans and profile reduction, the
kernels' byte arithmetic, and the plain reference that decides
``correct``.
"""
