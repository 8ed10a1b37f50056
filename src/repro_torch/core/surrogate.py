"""Surrogate-gradient spike function.

The Heaviside step `s = 1[v >= 0]` has zero gradient almost everywhere;
SNN training (SpikingJelly convention) replaces the backward pass with a
smooth surrogate. As in `repro.core.surrogate`, the ATan surrogate:

    d s / d v  :=  alpha / (2 * (1 + (pi/2 * alpha * v)^2))

The forward output is an exact binary {0,1} tensor in the input dtype, so
every full-event guarantee (bitwise SDSA, event counting) holds during
training too.
"""
from __future__ import annotations

import math

import torch

DEFAULT_ALPHA = 2.0


def atan_surrogate(v: torch.Tensor, alpha: float) -> torch.Tensor:
    """The ATan surrogate derivative at `v`, rounded operation by operation
    in this order (a true division last), as `csrc/lif.cu`'s backward
    kernel rounds it."""
    d = (0.5 * math.pi * alpha) * v
    return torch.div(torch.tensor(alpha / 2.0, dtype=v.dtype), 1.0 + d * d)


class _ATanSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, alpha):
        ctx.save_for_backward(v)
        ctx.alpha = alpha
        return (v >= 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * atan_surrogate(v, ctx.alpha).to(g.dtype), None


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return (v >= 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def spike(v: torch.Tensor, alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Binary spike: Heaviside(v) with the ATan surrogate gradient."""
    return _ATanSpike.apply(v, alpha)


def spike_st(v: torch.Tensor) -> torch.Tensor:
    """Straight-through variant (identity backward); used in ablations."""
    return _StraightThrough.apply(v)
