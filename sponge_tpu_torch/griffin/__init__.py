"""Griffin-pi: configuration, parameters, oracle and the batched permutation."""
