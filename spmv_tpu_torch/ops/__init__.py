"""Execution: the hand-written Hopper kernels (with their plain PyTorch
versions) and the plain PyTorch plans."""
from . import dia, sell, torch_csr
