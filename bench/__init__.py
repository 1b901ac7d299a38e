"""Benchmark of the PyTorch/CUDA port ``repro_torch`` on NVIDIA GPUs.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything that belongs to one model configuration (``configs/``), one
traffic mix (``traffic/``), one cell (``cells/``) or one per-layer metric
(``metrics/``) sits in a file of its own, found by its name.
"""
