"""Spike-driven self-attention (SDSA) — the Attention Core (Sec. III-C).

  Stage 1 (KV):   kv_mask = K AND V;  status = column-wise OR of kv_mask
  Stage 2 (QKV):  attn[i] = Q[i] AND status

Linear in sequence length: no N x N score matrix. `mode="sum"` is the
trainable accumulated form (Q * sum over N of K*V). Shapes: (..., N, d)
with heads in the leading axes.
"""
from __future__ import annotations

import torch


def kv_status_or(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Stage 1, OR form: (..., N, d) -> (..., d) binary status vector."""
    return (k * v).amax(dim=-2)


def kv_status_sum(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Stage 1, sum form: integer-valued column accumulation."""
    return (k * v).sum(dim=-2)


def sdsa_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             mode: str = "or") -> torch.Tensor:
    """Dense SDSA, the `ref` oracle of the dispatch registry (the name
    follows `repro.core.sdsa.sdsa_jnp`)."""
    if mode == "or":
        status = kv_status_or(k, v)
    elif mode == "sum":
        status = kv_status_sum(k, v)
    else:
        raise ValueError(f"unknown SDSA mode: {mode}")
    return q * status[..., None, :]


def sdsa(q, k, v, mode: str = "or") -> torch.Tensor:
    """Full SDSA routed through the backend registry: the dense oracle on
    CPU tensors, the packed CUDA kernel on CUDA tensors."""
    from repro_torch.kernels import dispatch
    return dispatch.sdsa(q, k, v, mode=mode)
