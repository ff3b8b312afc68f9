"""Poseidon2 parameters, oracle and the batched permutation (CUDA kernel 3)."""
