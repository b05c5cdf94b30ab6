"""The benchmark of the PyTorch and CUDA port (``repro_torch``): cooperative
GNN training on one H100.  ``bench/run.py`` is the entry point."""
