"""Attention layers: SDSA (the paper's Attention Core) for the spiking LM,
full-sequence and one-token decode.

SDSA runs on binary Q/K/V spikes: status[i] is the OR over micro-steps
and tokens j <= i of K AND V (causal), and the output is Q AND status, so
compute is O(N) and the decode state is O(d) per head. Spiking tensors
carry a leading T axis (micro-timesteps). Dense softmax GQA (the
`spiking=False` baseline, with its KV cache and RoPE) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.lif import LIFConfig
from repro_torch.kernels import dispatch
from .layers import dense_init, lif_fire

DENSE_ATTENTION_ITEM = "ROADMAP queue 1 item 10"


def attn_init(d_model: int, n_heads: int, n_kv: int, d_head: int,
              qk_norm: bool = False, dtype=torch.bfloat16, *,
              generator: torch.Generator, device="cuda") -> dict:
    p = {name: dense_init(d_in, d_out, dtype, generator=generator,
                          device=device)
         for name, d_in, d_out in (("w_q", d_model, n_heads * d_head),
                                   ("w_k", d_model, n_kv * d_head),
                                   ("w_v", d_model, n_kv * d_head),
                                   ("w_o", n_heads * d_head, d_model))}
    if qk_norm:
        dev = resolve_device(device)
        p["q_norm"] = {"scale": torch.ones((d_head,), device=dev)}
        p["k_norm"] = {"scale": torch.ones((d_head,), device=dev)}
    return p


def _project_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv: int,
                 d_head: int):
    """x: (..., N, D) -> q (..., N, H, dh), k / v (..., N, KV, dh)."""
    lead = tuple(x.shape[:-1])
    q = (x @ p["w_q"].to(x.dtype)).reshape(lead + (n_heads, d_head))
    k = (x @ p["w_k"].to(x.dtype)).reshape(lead + (n_kv, d_head))
    v = (x @ p["w_v"].to(x.dtype)).reshape(lead + (n_kv, d_head))
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., KV, dh) -> (..., KV*n_rep, dh): each KV head repeated n_rep
    times in place (`jnp.repeat`'s order; `Tensor.repeat` would tile)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=-2)


def attention_dense(*args, **kwargs):
    """Full-sequence softmax GQA with RoPE: not ported yet."""
    raise NotImplementedError(
        f"dense GQA attention (spiking=False) is not ported yet: "
        f"{DENSE_ATTENTION_ITEM}")


# ----------------------------------------------------------------- SDSA
def attention_sdsa(p: dict, s: torch.Tensor, *, n_heads: int, n_kv: int,
                   d_head: int, lif_cfg: LIFConfig, mode: str = "or",
                   causal: bool = True) -> torch.Tensor:
    """Spike-driven self-attention over a spike sequence.

    s: (T, B, N, D) binary. The Q/K/V drives are fired through LIF, K and
    V heads repeated for GQA, then the causal form goes through the
    registry's `causal_sdsa` op (prefix-OR kernel on the card) and the
    non-causal one folds the micro-steps into the token axis of the
    stateless `sdsa` op. `attention_sdsa_decode` is its streaming form."""
    q, k, v = _project_qkv(p, s, n_heads, n_kv, d_head)
    q, k, v = (lif_fire(x, lif_cfg) for x in (q, k, v))
    k = _repeat_kv(k, n_heads // n_kv)
    v = _repeat_kv(v, n_heads // n_kv)
    t, b, n = s.shape[0], s.shape[1], s.shape[2]
    # (T,B,N,H,dh) -> (T,B,H,N,dh): registry ops take the token axis at -2.
    qh, kh, vh = (x.transpose(2, 3) for x in (q, k, v))
    if causal:
        out = dispatch.causal_sdsa(qh, kh, vh, mode=mode)
    else:
        def fold(x):                             # (T,B,H,N,dh)->(B,H,T*N,dh)
            return x.permute(1, 2, 0, 3, 4).reshape(b, n_heads, t * n,
                                                    d_head)
        pooled = dispatch.sdsa(fold(qh), fold(kh), fold(vh), mode=mode)
        out = pooled.reshape(b, n_heads, t, n, d_head).permute(2, 0, 1, 3, 4)
    out = out.transpose(2, 3)                    # back to (T,B,N,H,dh)
    if mode == "sum":
        out = lif_fire(out, lif_cfg)             # FPE re-binarization
    out = out.reshape(t, b, n, n_heads * d_head)
    return out @ p["w_o"].to(out.dtype)


class SDSAState(NamedTuple):
    status: torch.Tensor   # (B, H, dh) running OR/sum over all past events


def sdsa_state_init(b: int, n_heads: int, d_head: int, dtype=torch.bfloat16,
                    device="cuda") -> SDSAState:
    return SDSAState(status=torch.zeros((b, n_heads, d_head), dtype=dtype,
                                        device=resolve_device(device)))


def attention_sdsa_decode(p: dict, s_t: torch.Tensor, state: SDSAState, *,
                          n_heads: int, n_kv: int, d_head: int,
                          lif_cfg: LIFConfig, mode: str = "or"):
    """One-token SDSA decode. s_t: (T, B, D) spikes of the new token ->
    ((T, B, D) output, new state). Folds the token's K/V spike phases into
    the O(d) status (the on-the-fly OR of Sec. III-C), then attends Q:
    the streaming form of `attention_sdsa`."""
    q, k, v = _project_qkv(p, s_t, n_heads, n_kv, d_head)   # (T,B,heads,dh)
    q, k, v = (lif_fire(x, lif_cfg) for x in (q, k, v))
    k = _repeat_kv(k, n_heads // n_kv)
    v = _repeat_kv(v, n_heads // n_kv)
    kv = k * v
    if mode == "or":
        status = torch.maximum(state.status,
                               kv.amax(dim=0).to(state.status.dtype))
    else:
        status = state.status + kv.sum(dim=0).to(state.status.dtype)
    out = q * status[None].to(q.dtype)
    if mode == "sum":
        out = lif_fire(out, lif_cfg)
    t, b = s_t.shape[0], s_t.shape[1]
    out = out.reshape(t, b, n_heads * d_head)
    return out @ p["w_o"].to(out.dtype), SDSAState(status)
