"""Plain PyTorch oracles for the kernels (the allclose targets)."""
from __future__ import annotations

import torch

from repro_torch.core.lif import LIFConfig, lif_scan as _lif_scan_core
from repro_torch.core.sdsa import kv_status_or


def lif_scan_ref(x: torch.Tensor, *, decay: float = 0.5, v_th: float = 1.0,
                 soft_reset: bool = True,
                 surrogate_alpha: float = 2.0) -> torch.Tensor:
    """Oracle for the LIF kernel: the core loop implementation."""
    cfg = LIFConfig(decay=decay, v_th=v_th, soft_reset=soft_reset,
                    surrogate_alpha=surrogate_alpha)
    return _lif_scan_core(x.float(), cfg).to(x.dtype)


def sdsa_status_ref(k_packed: torch.Tensor,
                    v_packed: torch.Tensor) -> torch.Tensor:
    """OR-reduce over N of K AND V, on packed words: (BH, N, dw) ->
    (BH, dw) uint32."""
    kv = k_packed.view(torch.int32) & v_packed.view(torch.int32)
    while kv.shape[1] > 1:                       # pairwise OR tree over N
        if kv.shape[1] % 2:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 1))
        kv = kv[:, 0::2] | kv[:, 1::2]
    return kv[:, 0].view(torch.uint32)


def sdsa_apply_ref(q_packed: torch.Tensor,
                   status: torch.Tensor) -> torch.Tensor:
    """out = Q AND status, broadcast over N."""
    out = q_packed.view(torch.int32) & status.view(torch.int32)[:, None, :]
    return out.view(torch.uint32)


def sdsa_packed_ref(q_packed, k_packed, v_packed):
    return sdsa_apply_ref(q_packed, sdsa_status_ref(k_packed, v_packed))


def sdsa_unpacked_ref(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Cross-check against the dense core implementation (OR form):
    (..., N, d) spikes x3 -> Q * (max over N of K * V)."""
    return q * kv_status_or(k, v)[..., None, :]


def sdsa_causal_status_ref(kv_packed: torch.Tensor) -> torch.Tensor:
    """Prefix-OR over the token axis of packed kv words: (BH, N, dw) ->
    (BH, N, dw) uint32, out[b, i] = OR over j <= i of kv[b, j]. A
    doubling (Hillis-Steele) scan on the int32 view: log2(N) shifted ORs,
    bit-exact for the uint32 words."""
    x = kv_packed.view(torch.int32)
    n = x.shape[1]
    shift = 1
    while shift < n:
        x = torch.cat([x[:, :shift], x[:, shift:] | x[:, :-shift]], dim=1)
        shift *= 2
    return x.contiguous().view(torch.uint32)


def spike_matmul_ref(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle for the spike matmul: plain dense fp32 matmul."""
    return torch.matmul(s.float(), w.float()).to(w.dtype)


def apec_decompose_packed_ref(s_packed: torch.Tensor, g: int):
    """Oracle for the APEC decompose kernel on packed words: (P, dw) ->
    (overlap (P/g, dw), residual (P, dw)), overlap = AND over each group
    of g adjacent rows, residual_i = s_i AND NOT overlap. Bitwise ops on
    the int32 view are bit-exact for the uint32 words."""
    p, dw = s_packed.shape
    grp = s_packed.view(torch.int32).reshape(p // g, g, dw)
    ov = grp[:, 0, :]
    for i in range(1, g):
        ov = ov & grp[:, i, :]
    res = (grp & ~ov[:, None, :]).reshape(p, dw)
    return ov.view(torch.uint32), res.view(torch.uint32)
