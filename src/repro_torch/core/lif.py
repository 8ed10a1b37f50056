"""Leaky integrate-and-fire (LIF) neuron dynamics, decay-multiplier form:

    v[t+1] = decay * v[t] + x[t]
    s[t]   = Heaviside(v[t+1] - v_th)
    reset:  soft: v <- v - s * v_th;   hard: v <- v * (1 - s)

The temporal loop here is a plain Python loop over T (the oracle), whose
autograd carries the ATan surrogate gradient of `core.surrogate.spike`;
`repro_torch.kernels.lif_scan` holds the CUDA kernels that keep `v` in a
register across the loop, forward and reversed-time backward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .surrogate import spike


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    decay: float = 0.5          # tau in the paper's notation
    v_th: float = 1.0
    soft_reset: bool = True
    surrogate_alpha: float = 2.0


def lif_step(v: torch.Tensor, x: torch.Tensor,
             cfg: LIFConfig = LIFConfig()) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep. Returns (new membrane potential, spikes)."""
    v = cfg.decay * v + x
    s = spike(v - cfg.v_th, cfg.surrogate_alpha)
    if cfg.soft_reset:
        v = v - s * cfg.v_th
    else:
        v = v * (1.0 - s)
    return v, s


def lif_scan(x: torch.Tensor, cfg: LIFConfig = LIFConfig(),
             v0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run LIF over the leading time axis. x: (T, ...) -> spikes (T, ...)."""
    v = torch.zeros_like(x[0]) if v0 is None else v0
    out = []
    for t in range(x.shape[0]):
        v, s = lif_step(v, x[t], cfg)
        out.append(s)
    return torch.stack(out)
