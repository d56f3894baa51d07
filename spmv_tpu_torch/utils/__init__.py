"""Utilities: pre-deal profiling."""

from .profiling import dev_put, predeal_profile

__all__ = ["dev_put", "predeal_profile"]
