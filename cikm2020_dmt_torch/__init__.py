"""PyTorch/CUDA port of the Deep Multifaceted Transformers ranking system.

Mirrors the module tree of ``cikm2020_dmt_tpu`` (the JAX reference) and
imports nothing from it.  Parameters are plain nested dicts of tensors with
the reference's layout (dense weights ``[in, out]``, logical ``[R, D]``
embedding tables), so converting a JAX checkpoint is a plain copy
(``convert.py``).  Hand-written CUDA kernels live under ``csrc/`` and are
built on first use (``ops/_build.py``).
"""
