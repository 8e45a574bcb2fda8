"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Configurations, traffic mixes, limits and per-layer
metric readers are data files found by name under this folder.
"""
