"""Spike-driven self-attention (OR form) on bit-packed spike words.

`sdsa_packed(q, k, v)` takes (BH, N, dw) uint32 words and returns
Q AND (OR over N of K AND V). `sdsa_causal_status(kv)` takes (BH, N, dw)
uint32 kv words and returns their prefix-OR over the token axis, the
causal (LM) status. On a CUDA tensor each launches its kernel
(`csrc/sdsa.cu`, `csrc/sdsa_causal.cu`); on a CPU tensor it runs the
plain version.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import sdsa_causal_status_ref, sdsa_packed_ref


sdsa_packed_plain = sdsa_packed_ref   # plain version: AND, OR tree, AND
sdsa_causal_status_plain = sdsa_causal_status_ref   # doubling OR scan


def sdsa_packed(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """(BH, N, dw) uint32 words x3 -> (BH, N, dw) uint32 words."""
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 3:
        raise ValueError(f"sdsa_packed needs three equal (BH, N, dw) "
                         f"operands, got {q.shape}, {k.shape}, {v.shape}")
    if not q.is_cuda:
        return sdsa_packed_plain(q, k, v)
    _build.require_cuda("sdsa_or", q, k, v, dtype=torch.uint32)
    bh, n, dw = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    _build.LAUNCHES["sdsa_or"] += 1
    _build.check(lib.sdsa_or_forward(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), bh, n, dw,
                                     _build.stream()), "sdsa_or")
    return out


def sdsa_causal_status(kv: torch.Tensor) -> torch.Tensor:
    """(BH, N, dw) uint32 kv words -> (BH, N, dw) uint32: out[b, i] = OR
    over tokens j <= i of kv[b, j]. Any N (no padding to a block)."""
    if kv.ndim != 3 or kv.dtype != torch.uint32:
        raise ValueError(f"sdsa_causal_status needs (BH, N, dw) uint32 "
                         f"words, got {tuple(kv.shape)} {kv.dtype}")
    if not kv.is_cuda:
        return sdsa_causal_status_plain(kv)
    _build.require_cuda("sdsa_causal", kv, dtype=torch.uint32)
    bh, n, dw = kv.shape
    out = torch.empty_like(kv)
    lib = _build.library()
    _build.LAUNCHES["sdsa_causal"] += 1
    _build.check(lib.sdsa_causal_forward(kv.data_ptr(), out.data_ptr(), bh,
                                         n, dw, _build.stream()),
                 "sdsa_causal")
    return out
