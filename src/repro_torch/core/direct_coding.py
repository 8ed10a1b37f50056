"""OPT1 — direct coding via bit-slicing (Algorithm 1, lines 1-4), the port
of `repro.core.direct_coding`.

The first layer of a direct-coded SNN receives multi-bit fixed-point
activations, which breaks pure event-driven execution. ExSpike quantizes
the input to signed B-bit fixed point, bit-slices it into B binary planes,
and duplicates/shifts the weights so the coding layer runs as binary
shift-and-accumulate on the same event machinery as every other layer.

Signed two's complement: value = -b_{B-1} 2^{B-1} + sum_{i<B-1} b_i 2^i,
so the MSB plane's weight copy carries a negative scale. The decomposition
is exact in integer arithmetic.

`quantize` keeps the batch-wide `x_max` and rounds half to even
(`torch.round`, like `jnp.round`), so `q * scale` equals the JAX value
bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .econv import tconv


def quantize(x: torch.Tensor, bits: int,
             x_max: Optional[float] = None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Symmetric signed quantization to `bits` bits.

    Returns (q, scale) with q int32 in [-2^{B-1}, 2^{B-1}-1] and
    x ~= q * scale (scale a 0-d float tensor on x's device).
    """
    if x_max is None:
        x_max = x.abs().max()
    x_max = torch.as_tensor(x_max, dtype=x.dtype, device=x.device)
    qmax = 2 ** (bits - 1) - 1
    scale = x_max / qmax
    q = torch.clamp(torch.round(x / scale), -(qmax + 1), qmax)
    return q.to(torch.int32), scale


def bit_slice(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Slice signed int q into B binary planes, leading axis (B, ...).

    Plane b holds bit b of the two's-complement representation (in
    `bits`-bit width), as exact binary {0,1} float spike planes.
    """
    uq = q.to(torch.int64) & ((1 << bits) - 1)
    shifts = torch.arange(bits, dtype=torch.int64, device=q.device)
    planes = (uq[None] >> shifts.reshape((bits,) + (1,) * q.ndim)) & 1
    return planes.to(torch.float32)


def plane_scales(bits: int, scale=1.0) -> torch.Tensor:
    """Per-plane weight scale (the paper's DuplicateShift): 2^b, MSB
    negative."""
    s = 2.0 ** torch.arange(bits, dtype=torch.float32)
    s[bits - 1] = -s[bits - 1]          # two's-complement sign plane
    scale = torch.as_tensor(scale, dtype=torch.float32)
    return s.to(scale.device) * scale


def direct_coded_matmul(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
                        x_max: Optional[float] = None) -> torch.Tensor:
    """Event-form first-layer matmul: bit-sliced x against shifted weights.

    Equal to (quantize(x) * scale) @ w, but every multiply is a
    binary-activation accumulate. x: (..., K); w: (K, N).
    """
    q, scale = quantize(x, bits, x_max)
    planes = bit_slice(q, bits)                      # (B, ..., K) binary
    per_plane = torch.einsum("b...k,kn->b...n", planes, w)
    return torch.einsum("b,b...n->...n", plane_scales(bits, scale),
                        per_plane)


def direct_coded_conv(x: torch.Tensor, w: torch.Tensor, bits: int = 8,
                      stride: int = 1, padding: str = "SAME",
                      x_max: Optional[float] = None) -> torch.Tensor:
    """Event-form direct-coding conv layer (NHWC, HWIO weights): one fp32
    conv per bit plane, planes folded into the batch."""
    q, scale = quantize(x, bits, x_max)
    planes = bit_slice(q, bits)                      # (B, N, H, W, C)
    per_plane = tconv(planes.reshape((-1,) + tuple(x.shape[1:])), w,
                      stride, padding)
    per_plane = per_plane.reshape((bits,) + tuple(x.shape[:1]) +
                                  tuple(per_plane.shape[1:]))
    return torch.einsum("b,bnhwc->nhwc", plane_scales(bits, scale),
                        per_plane)


def reference_quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                               bits: int = 8,
                               x_max: Optional[float] = None) -> torch.Tensor:
    """Oracle: the dequantized fixed-point matmul the event form must
    match."""
    q, scale = quantize(x, bits, x_max)
    return (q.to(torch.float32) * scale) @ w


def reference_quantized_conv(x: torch.Tensor, w: torch.Tensor,
                             bits: int = 8, stride: int = 1,
                             padding: str = "SAME",
                             x_max: Optional[float] = None) -> torch.Tensor:
    q, scale = quantize(x, bits, x_max)
    return tconv(q.to(torch.float32) * scale, w, stride, padding)
