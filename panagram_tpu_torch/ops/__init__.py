"""Device operations: codec, counting, dictionary, table, kernels, anchoring."""
