"""GMiMC-erf: configuration, parameters, oracle and the batched permutation."""
