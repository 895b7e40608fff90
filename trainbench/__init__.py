"""Benchmark of the PyTorch and CUDA port's training plane (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``reference/`` is the plain
PyTorch reference its comparison holds the program to.
"""
