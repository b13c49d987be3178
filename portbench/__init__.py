"""The benchmark of the PyTorch port (``run.py``); see ``PERF.md``."""
