"""Optimizer substrate: AdamW, schedules, gradient compression."""
from . import adamw, grad_compress, schedule
__all__ = ["adamw", "grad_compress", "schedule"]
