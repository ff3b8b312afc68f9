"""Monolith: configuration, parameters, oracle and the batched permutation."""
