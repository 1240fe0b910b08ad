"""Frozen copies of the dataset generators, one module a dataset, each with
``generate(n, seed) -> float32 (n, 3)``. They are copies, not imports, so
that a change to the program cannot change what the benchmark feeds it."""
