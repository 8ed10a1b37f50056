"""Error-feedback int8 gradient compression, the port of
`repro.optim.grad_compress`.

Per-leaf gradients are quantized to int8 values with a per-leaf scale,
and the quantization error is carried into the next step (error
feedback, as in 1-bit Adam / EF-SGD), so convergence is preserved. The
wire format is int8-valued numbers carried in bf16 (exact summation for
up to 256 data shards), half the all-reduce bytes of f32.

The transform is pure: the error buffers live beside the optimizer state,
and `compress` returns new trees (nothing is written in place). On a
rank mesh the train step compresses the gradient after the batch sum,
as the reference's numbers demand, so the wire crosses no collective and
saves no bytes there; each leaf's scale must read the whole leaf's max,
so `compress` takes the function that reduces the ranks' maxima
(`launch.steps`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim.adamw import leaves, unflatten


class EFState(NamedTuple):
    error: Any   # residual tree, same structure as grads (bf16)


def init(params: Any) -> EFState:
    return EFState(error=unflatten(params, [
        torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
        for p in leaves(params)]))


def _fed(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    return g.float() + e.float()


def _one(g: torch.Tensor, e: torch.Tensor, amax: torch.Tensor):
    g32 = _fed(g, e)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    err = g32 - q * scale
    return q.to(torch.bfloat16), scale, err.to(torch.bfloat16)


def compress(grads: Any, ef: EFState,
             whole_max: Optional[Callable[[list], list]] = None
             ) -> Tuple[Any, Any, EFState]:
    """Returns (wire grads: bf16 holding int8 values, per-leaf f32 scales,
    new error-feedback state). Each leaf's scale is its max |g + e| over
    127; `whole_max`, where given, maps the per-leaf maxima of this
    process's blocks to those of the whole leaves (a rank mesh's MAX
    all-reduce)."""
    pairs = list(zip(leaves(grads), leaves(ef.error)))
    # g + e is formed again for the quantisation: one leaf's f32 copy at a
    # time, never the whole tree's
    amax = [_fed(g, e).abs().max() for g, e in pairs]
    if whole_max is not None:
        amax = whole_max(amax)
    out = [_one(g, e, m) for (g, e), m in zip(pairs, amax)]
    wire, scales, err = (unflatten(grads, [o[i] for o in out])
                         for i in range(3))
    return wire, scales, EFState(error=err)


def decompress(wire: Any, scales: Any) -> Any:
    return unflatten(wire, [q.float() * s for q, s in
                            zip(leaves(wire), leaves(scales))])
