"""Attention layers: dense GQA (the `spiking=False` baseline, with its KV
cache) and SDSA (the paper's Attention Core), each full-sequence and
one-token decode.

Dense GQA is softmax attention with RoPE, optional qk-norm and a sliding
window: O(N^2) over the sequence, with a real KV cache in decode. Its
products are plain tensor ops (`@`, `einsum`, `softmax`); no TPU kernel
stands behind them in the reference either.

SDSA runs on binary Q/K/V spikes: status[i] is the OR over micro-steps
and tokens j <= i of K AND V (causal), and the output is Q AND status, so
compute is O(N) and the decode state is O(d) per head. Spiking tensors
carry a leading T axis (micro-timesteps).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.lif import LIFConfig
from repro_torch.kernels import dispatch
from .layers import apply_rope, dense_init, lif_fire, rmsnorm, rope_angles


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


# ------------------------------------------------------------- dense (GQA)
def attention_dense(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    d_head: int, causal: bool = True,
                    window: Optional[int] = None, qk_norm: bool = False,
                    rope_theta: float = 1e4,
                    kv_block: int = 1024) -> torch.Tensor:
    """Full-sequence softmax GQA. x: (B, N, D) -> (B, N, D).

    For N > kv_block it runs the blockwise (flash-style) online softmax
    over KV chunks, O(N * kv_block) live score memory instead of O(N^2);
    N must then be a multiple of kv_block, as in the reference."""
    b, n, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    sin, cos = rope_angles(torch.arange(n, device=x.device), d_head,
                           rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    k = _repeat_kv(k, n_heads // n_kv)
    v = _repeat_kv(v, n_heads // n_kv)
    q, k, v = (t.transpose(-3, -2) for t in (q, k, v))        # (B, H, N, dh)
    scale = d_head ** -0.5
    if n <= kv_block:
        scores = (q @ k.transpose(-1, -2)).float() * scale
        scores = scores + _mask(n, n, 0, causal, window, x.device)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        out = probs @ v
    else:
        out = _blockwise_attention(q, k, v, scale, causal, window, kv_block)
    out = out.transpose(-3, -2).reshape(b, n, n_heads * d_head)
    return out @ p["w_o"].to(out.dtype)


def _mask(nq: int, nk: int, k_start: int, causal: bool,
          window: Optional[int], device) -> torch.Tensor:
    """(nq, nk) additive f32 mask: -inf where key k_start + j is hidden
    from query i (in the future when causal, or window or more behind)."""
    qpos = torch.arange(nq, device=device)[:, None]
    kpos = k_start + torch.arange(nk, device=device)[None, :]
    m = torch.zeros((nq, nk), dtype=torch.float32, device=device)
    if causal:
        m = m.masked_fill(kpos > qpos, -math.inf)
    if window is not None:
        m = m.masked_fill(kpos < qpos - window + 1, -math.inf)
    return m


def _blockwise_attention(q, k, v, scale: float, causal: bool,
                         window: Optional[int],
                         kv_block: int) -> torch.Tensor:
    """Online softmax over KV chunks (the flash-attention recurrence).
    q, k, v: (B, H, N, dh) -> (B, H, N, dh) in q's dtype.

    A query row whose every key so far was masked keeps a running max of
    -inf; its correction is then 0 and its block weights 0, where the
    reference's exp(-inf - -inf) gives NaN (a row whose first KV block a
    sliding window hides entirely). Every other row computes exactly the
    reference's recurrence."""
    b, h, n, dh = q.shape
    if n % kv_block:
        raise ValueError(f"blockwise attention needs N ({n}) to be a "
                         f"multiple of kv_block ({kv_block})")
    m_run = torch.full((b, h, n), -math.inf, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n, dh), dtype=torch.float32, device=q.device)
    for start in range(0, n, kv_block):
        kb = k[:, :, start:start + kv_block]
        vb = v[:, :, start:start + kv_block]
        s = (q @ kb.transpose(-1, -2)).float() * scale
        s = s + _mask(n, kv_block, start, causal, window, q.device)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # exp(x - -inf) is NaN at x = -inf: measure from 0 while nothing
        # is visible, which makes both the weights and the correction 0.
        m_ref = torch.where(torch.isneginf(m_new), 0.0, m_new)
        pr = torch.exp(s - m_ref[..., None])
        corr = torch.exp(m_run - m_ref)
        l_run = l_run * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + (pr.to(vb.dtype) @ vb).float()
        m_run = m_new
    return (acc / l_run.clamp_min(1e-30)[..., None]).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S, KV, dh)
    v: torch.Tensor      # (B, S, KV, dh)


def kv_cache_init(b: int, s: int, n_kv: int, d_head: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    dev = resolve_device(device)
    return KVCache(k=torch.zeros((b, s, n_kv, d_head), dtype=dtype,
                                 device=dev),
                   v=torch.zeros((b, s, n_kv, d_head), dtype=dtype,
                                 device=dev))


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """a, b in their common dtype (a f32 query against the bf16 cache is
    f32 math, as jnp's promotion makes it)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def attention_dense_decode(p: dict, x_t: torch.Tensor, cache: KVCache, pos,
                           *, n_heads: int, n_kv: int, d_head: int,
                           window: Optional[int] = None,
                           qk_norm: bool = False, rope_theta: float = 1e4,
                           masked_cache_update: bool = True):
    """One-token GQA decode. x_t: (B, D); pos: a scalar or per-slot (B,)
    positions -> ((B, D) output, new cache).

    Each slot decodes at its own position: the RoPE angle, the cache row
    written and the causal mask all read pos[b]. `masked_cache_update`
    writes the new K / V by a one-hot `torch.where` merge over the whole
    cache (the config's `decode_masked_update`); False writes row pos[b]
    of each slot by index (clamped into the cache, as
    `dynamic_update_slice` clamps). Either way the input cache is not
    written. The scores group q as (B, KV, rep, dh), head h = g * rep + r
    (`_repeat_kv`'s order), so the repeated cache is never built."""
    b = x_t.shape[0]
    s_len = cache.k.shape[1]
    pos = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int64, device=x_t.device), (b,))
    q, k, v = _project_qkv(p, x_t[:, None, :], n_heads, n_kv, d_head)
    if qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    sin, cos = rope_angles(pos[:, None], d_head, rope_theta)  # (B,1,dh/2)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if masked_cache_update:
        hit = (torch.arange(s_len, device=x_t.device)[None, :]
               == pos[:, None])[..., None, None]
        new_k = torch.where(hit, k.to(cache.k.dtype), cache.k)
        new_v = torch.where(hit, v.to(cache.v.dtype), cache.v)
    else:
        rows = torch.arange(b, device=x_t.device)
        at = pos.clamp(0, s_len - 1)
        new_k, new_v = cache.k.clone(), cache.v.clone()
        new_k[rows, at] = k[:, 0].to(cache.k.dtype)
        new_v[rows, at] = v[:, 0].to(cache.v.dtype)
    rep = n_heads // n_kv
    qg = q[:, 0].reshape(b, n_kv, rep, d_head)                # (B,KV,rep,dh)
    qs, ks = _promoted(qg, new_k)
    scores = torch.einsum("bgrd,bsgd->bgrs", qs, ks).float()
    scores = scores * (d_head ** -0.5)
    kpos = torch.arange(s_len, device=x_t.device)[None, None, None, :]
    pos_b = pos[:, None, None, None]
    valid = kpos <= pos_b
    if window is not None:
        valid = valid & (kpos > pos_b - window)
    scores = scores.masked_fill(~valid, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ps, vs = _promoted(probs, new_v)
    out = torch.einsum("bgrs,bsgd->bgrd", ps, vs)             # (B,KV,rep,dh)
    out = out.reshape(b, n_heads * d_head)
    return out @ p["w_o"].to(out.dtype), KVCache(new_k, new_v)


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
