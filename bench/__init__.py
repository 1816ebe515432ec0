"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``bench/run.py`` runs one cell; ``BENCHMARK.json`` at the checkout's root
lists the cells, configurations and metrics.
"""
