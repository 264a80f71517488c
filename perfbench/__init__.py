"""The benchmark of the PyTorch port (``repro_torch``) on one H100.

``run.py`` runs one cell of ``BENCHMARK.json``; ``configs/``, ``traffic/``
and ``workloads/`` hold each configuration, traffic mix and cell's limits
as data; ``drivers/`` the two ways of driving the program (a closed
serving loop, the training loop); ``metrics/`` one reader a per-layer
metric; ``reference/`` the plain f32 model and optimizer that decide
``correct``; ``cost.py`` the frozen operation and byte counts.
"""
