"""Rescue-Prime parameters, oracle and the batched permutation (CUDA kernel 5)."""
