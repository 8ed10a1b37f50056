"""CNN building blocks (the conv initializer the SPS stem shares)."""
from __future__ import annotations

import torch


def _conv_init(k: int, ci: int, co: int, *, generator: torch.Generator,
               device="cpu") -> torch.Tensor:
    """He-scaled normal (k, k, ci, co) HWIO conv weights."""
    scale = (2.0 / (k * k * ci)) ** 0.5
    w = torch.randn((k, k, ci, co), generator=generator) * scale
    return w.to(device)
