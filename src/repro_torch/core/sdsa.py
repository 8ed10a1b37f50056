"""Spike-driven self-attention (SDSA) — the Attention Core (Sec. III-C).

  Stage 1 (KV):   kv_mask = K AND V;  status = column-wise OR of kv_mask
  Stage 2 (QKV):  attn[i] = Q[i] AND status

Linear in sequence length: no N x N score matrix. `mode="sum"` is the
trainable accumulated form (Q * sum over N of K*V). Shapes: (..., N, d)
with heads in the leading axes.

The causal (LM) form pools K AND V over the T micro-steps and accumulates
it over tokens j <= i (a prefix-OR); its streaming form carries only the
d-bit status per head (`sdsa_decode_update` / `sdsa_decode_attend`), so
prefill and token-by-token decode agree exactly. Its gradient is the
reference's: `jax.lax.cummax` differentiates as a parallel prefix scan of
`lax.max`, which splits a tie's cotangent in halves at every combine
(`prefix_max`).
"""
from __future__ import annotations

import torch


def kv_status_or(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Stage 1, OR form: (..., N, d) -> (..., d) binary status vector."""
    return (k * v).amax(dim=-2)


def kv_status_sum(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Stage 1, sum form: integer-valued column accumulation."""
    return (k * v).sum(dim=-2)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Along axis 0: even[0], odd[0], even[1], ... (len(even) is len(odd)
    or one more)."""
    n = odd.shape[0]
    pairs = torch.stack([even[:n], odd], 1).reshape((2 * n,) +
                                                    tuple(odd.shape[1:]))
    return torch.cat([pairs, even[n:]], 0) if even.shape[0] > n else pairs


def _scan_max(e: torch.Tensor) -> torch.Tensor:
    """Prefix max over axis 0 as `jax.lax.associative_scan(lax.max, e)`
    combines it, pair by pair; `torch.maximum` splits a tie's gradient in
    halves as `lax.max` does."""
    n = e.shape[0]
    if n < 2:
        return e
    odd = _scan_max(torch.maximum(e[0:-1:2], e[1::2]))
    even = torch.maximum(odd[:-1] if n % 2 == 0 else odd, e[2::2])
    return _interleave(torch.cat([e[:1], even], 0), odd)


class _PrefixMax(torch.autograd.Function):
    """`torch.cummax` forward; the backward of the reference's scan."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.save_for_backward(x)
        ctx.dim = dim
        return torch.cummax(x, dim=dim).values

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().movedim(ctx.dim, 0).requires_grad_(True)
            out = _scan_max(xs)
            (dx,) = torch.autograd.grad(out, xs, g.movedim(ctx.dim, 0))
        return dx.movedim(0, ctx.dim), None


def prefix_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Running max along `dim` (the causal prefix-OR on {0, 1} spikes),
    differentiable with `jax.lax.cummax`'s gradient."""
    return _PrefixMax.apply(x, dim)


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
        status = prefix_max(phase, phase.ndim - 2)
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
