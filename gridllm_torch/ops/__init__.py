"""Tensor ops: layers, KV cache, attention, sampling and the CUDA kernels."""
