"""Hand-written Hopper kernels of the port (sources in ``repro_torch/csrc``),
each beside its plain PyTorch version; ``ops`` holds the public wrappers."""
