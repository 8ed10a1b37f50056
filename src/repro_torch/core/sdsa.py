"""Spike-driven self-attention (SDSA) — the Attention Core (Sec. III-C).

  Stage 1 (KV):   kv_mask = K AND V;  status = column-wise OR of kv_mask
  Stage 2 (QKV):  attn[i] = Q[i] AND status

Linear in sequence length: no N x N score matrix. `mode="sum"` is the
trainable accumulated form (Q * sum over N of K*V). Shapes: (..., N, d)
with heads in the leading axes.

The causal (LM) form pools K AND V over the T micro-steps and accumulates
it over tokens j <= i (a prefix-OR); its streaming form carries only the
d-bit status per head (`sdsa_decode_update` / `sdsa_decode_attend`), so
prefill and token-by-token decode agree exactly.
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
    CPU tensors, the SDSA kernel on CUDA tensors."""
    from repro_torch.kernels import dispatch
    return dispatch.sdsa(q, k, v, mode=mode)


def causal_sdsa_jnp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "or") -> torch.Tensor:
    """Causal (LM) SDSA, the `ref` oracle of the `causal_sdsa` registry op
    (the name follows `repro.core.sdsa.causal_sdsa_jnp`).

    q, k, v: (T, ..., N, d) binary spikes, T the micro-step axis and N the
    token axis. The kv mask pools over micro-steps, then status[i]
    accumulates over tokens j <= i:

      mode="or":  status = prefix-OR (cummax on {0,1});  out = Q AND status
      mode="sum": status = prefix sum of event counts;   out = Q * status
    """
    kv = k * v                                     # AND   (T, ..., N, d)
    if mode == "or":
        phase = kv.amax(dim=0)                     # OR over micro-steps
        status = torch.cummax(phase, dim=phase.ndim - 2).values
    elif mode == "sum":
        status = torch.cumsum(kv.sum(dim=0), dim=-2)
    else:
        raise ValueError(f"unknown SDSA mode: {mode}")
    return q * status[None]


def causal_sdsa_packed_jnp(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           mode: str = "or") -> torch.Tensor:
    """Bit-packed causal SDSA in plain tensor ops (uint32 word semantics,
    no kernel): pack -> AND -> OR-fold T -> prefix-OR over tokens -> AND
    -> unpack. "or" only (the registry's gate refuses the rest)."""
    del mode
    from repro_torch.kernels.ops import causal_sdsa_words
    from repro_torch.kernels.ref import sdsa_causal_status_ref
    return causal_sdsa_words(q, k, v, sdsa_causal_status_ref)


def causal_sdsa(q, k, v, mode: str = "or") -> torch.Tensor:
    """Causal SDSA routed through the backend registry. q, k, v:
    (T, ..., N, d) binary spikes -> (T, ..., N, d)."""
    from repro_torch.kernels import dispatch
    return dispatch.causal_sdsa(q, k, v, mode=mode)


def sdsa_decode_init(head_shape: tuple, mode: str = "or",
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Initial streaming state: zeros(..., d) on `device`."""
    del mode
    from repro_torch import resolve_device
    return torch.zeros(head_shape, dtype=dtype, device=resolve_device(device))


def sdsa_decode_update(status: torch.Tensor, k_t: torch.Tensor,
                       v_t: torch.Tensor, mode: str = "or") -> torch.Tensor:
    """Fold one token's K, V spikes into the running status (an O(d)
    update: the hardware's on-the-fly OR during V write-back)."""
    kv = k_t * v_t
    if mode == "or":
        return torch.maximum(status, kv)
    return status + kv


def sdsa_decode_attend(q_t: torch.Tensor, status: torch.Tensor) -> torch.Tensor:
    """Stage 2 for one token: Q AND (times) status."""
    return q_t * status


def sdsa_cross(q, k_enc, v_enc, mode: str = "or") -> torch.Tensor:
    """Cross-attention variant: the status comes from encoder K, V."""
    return sdsa(q, k_enc, v_enc, mode=mode)


def sdsa_ops(n: int, d: int) -> int:
    """Logic-op count: stage-1 AND (N*d) + OR-reduce (N*d) + stage-2 AND
    (N*d), against softmax attention's 2*N^2*d MACs."""
    return 3 * n * d


def softmax_attention_ops(n: int, d: int) -> int:
    return 2 * n * n * d
