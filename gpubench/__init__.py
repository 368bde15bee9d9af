"""The benchmark of presto_tpu_torch on an NVIDIA GPU.

``run.py`` runs one cell of ``BENCHMARK.json``; everything a cell needs
(configuration, traffic mix, query templates, plain references, per-layer
metric readers) is found by name under this folder.
"""
