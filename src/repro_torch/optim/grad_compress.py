"""Error-feedback int8 gradient compression, the port of
`repro.optim.grad_compress`.

Per-leaf gradients are quantized to int8 values with a per-leaf scale,
and the quantization error is carried into the next step (error
feedback, as in 1-bit Adam / EF-SGD), so convergence is preserved. The
wire format is int8-valued numbers carried in bf16 (exact summation for
up to 256 data shards), half the all-reduce bytes of f32.

The transform is pure: the error buffers live beside the optimizer state,
and `compress` returns new trees (nothing is written in place).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import leaves, unflatten


class EFState(NamedTuple):
    error: Any   # residual tree, same structure as grads (bf16)


def init(params: Any) -> EFState:
    return EFState(error=unflatten(params, [
        torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        for p in leaves(params)]))


def _one(g: torch.Tensor, e: torch.Tensor):
    g32 = g.float() + e.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    err = g32 - q * scale
    return q.to(torch.bfloat16), scale, err.to(torch.bfloat16)


def compress(grads: Any, ef: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (wire grads: bf16 holding int8 values, per-leaf f32 scales,
    new error-feedback state)."""
    out = [_one(g, e) for g, e in zip(leaves(grads), leaves(ef.error))]
    wire, scales, err = (unflatten(grads, [o[i] for o in out])
                         for i in range(3))
    return wire, scales, EFState(error=err)


def decompress(wire: Any, scales: Any) -> Any:
    return unflatten(wire, [q.float() * s for q, s in
                            zip(leaves(wire), leaves(scales))])
