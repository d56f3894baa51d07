"""Execution: the hand-written Hopper kernels (with their plain PyTorch
versions) and the plain PyTorch plans."""
from . import coo2, csr_split, dia, sell, sell_cs, torch_csr
