"""The H100 benchmark of the PyTorch port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; everything a cell
needs is found by name under this folder (``configs/``, ``traffic/``,
``metrics/``, ``kernels/``, ``limits/``).  See ``PERF.md`` at the
repository root for what each piece measures.
"""
