"""Hand-written CUDA kernels for Hopper and their torch wrappers.

Importing this package builds nothing: the kernels are compiled by nvcc on
first launch (tpinn_torch.kernels.build)."""
