"""Spike function, forward only.

The Heaviside step `s = 1[v >= 0]`: an exact binary {0,1} tensor in the
input dtype. The ATan surrogate gradient (an `autograd.Function`) comes
with the training slice.
"""
from __future__ import annotations

import torch

DEFAULT_ALPHA = 2.0


def spike(v: torch.Tensor, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Binary spike: Heaviside(v). `alpha` is the surrogate's slope, kept
    for signature parity; the forward does not read it."""
    del alpha
    return (v >= 0).to(v.dtype)
