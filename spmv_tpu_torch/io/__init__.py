"""Synthetic generators (Matrix Market I/O is not ported yet)."""
from . import generate
