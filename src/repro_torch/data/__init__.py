"""Data substrate: synthetic generators + sharded prefetching pipeline."""
from . import pipeline, synthetic
__all__ = ["pipeline", "synthetic"]
