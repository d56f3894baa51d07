"""I/O: Matrix Market parsing, binary cache, synthetic generators."""
from . import mmio, generate
