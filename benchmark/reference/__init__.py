"""Plain PyTorch references of the benchmark's configurations.

Nothing here imports the program under test (``tpinn_torch``) or JAX: the
references build their own inputs from the seed, take their input
derivatives by autograd, and work out again whatever the program derives
from the shared inputs (normalization, boundary values, fit targets).
"""
