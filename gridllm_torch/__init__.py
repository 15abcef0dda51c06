"""gridllm_torch: the serving stack of gridllm_tpu ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

The JAX package `gridllm_tpu` is the reference this package is held
against in tests/test_torch_*.py; this package imports none of it (and no
JAX). Entry points run on CUDA unless the caller passes device="cpu".
"""
