"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; everything that belongs
to one configuration, traffic mix, index adapter, reference or per-layer
metric sits in a file of its own that the harness finds by name.
"""
