"""Poseidon parameters, oracle, sparse factorization and the batched permutation."""
