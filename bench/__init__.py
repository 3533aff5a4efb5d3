"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once; everything a
cell, a configuration, a traffic mix or a per-layer metric owns sits in a
file of its own under ``bench/`` and is found by its name.  Nothing here
imports JAX, the JAX package or ``benchmarks/``.
"""
