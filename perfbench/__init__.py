"""The benchmark of the PyTorch and CUDA port (``cikm2020_dmt_torch``): see
``perfbench/run.py``."""
