"""Shared model layers: params as plain dicts of tensors, pure apply
functions. Spiking layers take and return an explicit leading T axis
(micro-timesteps); LIF is the only op that couples timesteps.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.events import EventTensor
from repro_torch.core.lif import LIFConfig


def dense_init(d_in: int, d_out: int, *, generator: torch.Generator,
               device="cpu") -> torch.Tensor:
    """Truncated-normal (±2 sigma) Glorot-scaled (d_in, d_out) weights."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.empty((d_in, d_out), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(device)


def hybrid_scope(spiking_cfg):
    """Dispatch scope a model's apply body runs under: a null context.
    Density-adaptive hybrid routing (`SpikingConfig.hybrid=True`) is not
    ported yet and raises."""
    if getattr(spiking_cfg, "hybrid", False):
        raise NotImplementedError(
            "SpikingConfig(hybrid=True) waits for the hybrid router port "
            "(ROADMAP queue 1, item 13)")
    return contextlib.nullcontext()


def lif_fire(x: torch.Tensor, lif_cfg: LIFConfig) -> torch.Tensor:
    """Binarize pre-activations into spikes over the leading T axis,
    routed through the backend registry (the CUDA kernel on the card)."""
    from repro_torch.kernels import dispatch
    return dispatch.lif_scan(x, decay=lif_cfg.decay, v_th=lif_cfg.v_th,
                             soft_reset=lif_cfg.soft_reset,
                             surrogate_alpha=lif_cfg.surrogate_alpha)


def lif_fire_events(x: torch.Tensor, lif_cfg: LIFConfig,
                    packed: bool = False) -> EventTensor:
    """Fire AND carry the event metadata: the full-event producer. The
    fused kernel emits the (128, 128) per-tile occupancy map and its
    8-row chunk refinement while it writes the spikes; the returned
    `EventTensor` lets the next event op skip its occupancy pre-pass."""
    if packed:
        raise NotImplementedError(
            "packed spike payloads wait for the packed-payload port "
            "(ROADMAP queue 1, item 12)")
    from repro_torch.kernels import dispatch
    s, occ, chunks = dispatch.lif_scan_occ(
        x, decay=lif_cfg.decay, v_th=lif_cfg.v_th,
        soft_reset=lif_cfg.soft_reset,
        surrogate_alpha=lif_cfg.surrogate_alpha)
    return EventTensor(s, occ, chunks=chunks)
