"""SpikingFormer-L-D (the paper's transformer workloads, Table II).

A Spiking Patch Splitting (SPS) conv stem downsamples 32x32 images into
8x8 = 64 tokens of dimension D, then L encoder blocks of spike-driven
self-attention (SSA, the Attention Core's OR form) and a spiking MLP
(FFN), with membrane-shortcut residuals and a rate-decoded head.
The params are a plain dict of tensors with the same tree and layouts as
`repro.models.spikingformer`. `spikingformer_apply` is differentiable
(surrogate gradients through every registry op); inference callers enter
`torch.inference_mode()` themselves. A training step is composed by the
caller, as in `repro`: cross-entropy of the logits, `torch.autograd.grad`
over the parameter leaves, `optim.adamw.update`. `SpikingConfig(packed=
True)` carries uint32 words between the spiking layers (inference only).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SpikingConfig
from repro_torch.core.econv import econv, tconv
from repro_torch.core.events import max_pool_events
from repro_torch.core.lif import LIFConfig
from repro_torch.kernels import dispatch
from .cnn import _conv_init
from .layers import dense_init, hybrid_scope, lif_fire, lif_fire_events
# The param tree converters live in `layers` (shared with the CNNs) and
# stay importable from here.
from .layers import params_from_numpy, params_to_numpy  # noqa: F401

Params = Dict[str, Any]


def spikingformer_init(depth: int, dim: int, n_classes: int = 10,
                       in_ch: int = 3, *,
                       generator: torch.Generator | None = None,
                       device="cuda") -> Params:
    """Random SpikingFormer-`depth`-`dim` params drawn from `generator`
    (on the CPU, so a seed gives the same weights on every device)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    sps_dims = (dim // 8, dim // 4, dim // 2, dim)
    p: Params = {"sps": [], "blocks": []}
    ci = in_ch
    for co in sps_dims:
        p["sps"].append(_conv_init(3, ci, co, generator=g, device=dev))
        ci = co
    for _ in range(depth):
        p["blocks"].append({
            name: dense_init(d_in, d_out, generator=g, device=dev)
            for name, d_in, d_out in (
                ("w_q", dim, dim), ("w_k", dim, dim), ("w_v", dim, dim),
                ("w_o", dim, dim), ("w_fc1", dim, 4 * dim),
                ("w_fc2", 4 * dim, dim))})
    p["head"] = dense_init(dim, n_classes, generator=g, device=dev)
    return p


def spikingformer_apply(p: Params, x: torch.Tensor, n_heads: int = 8,
                        spiking_cfg: SpikingConfig = SpikingConfig(t_steps=4),
                        collect_stats: bool = False):
    """x: (B, 32, 32, C) on the params' device -> logits (B, n_classes)
    [, spike maps per stage]."""
    if x.device != p["head"].device:
        raise ValueError(f"input on {x.device}, params on {p['head'].device}")
    with hybrid_scope(spiking_cfg):
        return _spikingformer_body(p, x, n_heads, spiking_cfg, collect_stats)


def _spikingformer_body(p, x, n_heads, spiking_cfg, collect_stats):
    lif = LIFConfig(decay=spiking_cfg.lif_decay, v_th=spiking_cfg.lif_vth)
    t = spiking_cfg.t_steps
    b = x.shape[0]
    s = x.float().unsqueeze(0).expand((t,) + tuple(x.shape))
    stats: List[torch.Tensor] = []

    # SPS: conv -> LIF x4, maxpool after stages 2 and 3 (32 -> 8). Stage 0
    # eats the direct-coded (multi-bit) image and stays a dense conv; from
    # stage 1 on the stream is full-event: each fire emits spikes with
    # their maps, the (T,B)->(T*B) fold and the pooling carry the maps,
    # and each econv consumes them instead of re-deriving occupancy. In
    # packed mode the fires emit uint32 words, the pooling ORs them and
    # the econvs take them (no f32 spikes between the stages).
    packed = spiking_cfg.packed
    for i, w in enumerate(p["sps"]):
        tb = tuple(s.shape[:2])
        flat = s.reshape((-1,) + tuple(s.shape[2:]))
        drive = tconv(flat, w) if i == 0 else econv(flat, w)
        drive = drive.reshape(tb + tuple(drive.shape[1:]))
        s = lif_fire_events(drive, lif, packed=packed)
        if i in (1, 2):
            s = max_pool_events(s, 2)
        if collect_stats:
            stats.append(s.dense())

    dim = s.shape[-1]
    n_tok = s.shape[2] * s.shape[3]
    tokens = s.reshape(t, b, n_tok, dim)         # (T,B,N,D), map survives
    # The membrane stream is continuous from here on: `.dense()` is the
    # explicit unpack at the SPS/transformer boundary.
    x_mp = tokens.dense()

    for blk in p["blocks"]:
        # SSA: q/k/v spikes -> Attention Core (non-causal OR form). The
        # head split changes the trailing axis, so no map is carried into
        # SDSA (which consumes packed words, not occupancy).
        def heads(w):
            return lif_fire(x_mp @ w, lif).reshape(
                t, b, n_tok, n_heads, dim // n_heads).transpose(2, 3)
        attn = dispatch.sdsa(heads(blk["w_q"]), heads(blk["w_k"]),
                             heads(blk["w_v"]), mode=spiking_cfg.sdsa_mode)
        attn = attn.transpose(2, 3).reshape(t, b, n_tok, dim)
        if collect_stats:
            stats.append(attn)
        x_mp = x_mp + attn @ blk["w_o"]
        # Spiking MLP (FFN): full-event — both fires carry their maps and
        # both projections consume them through the registry matmul (on
        # words in packed mode; q/k/v above stay dense into SDSA).
        h = lif_fire_events(x_mp, lif, packed=packed)
        h = lif_fire_events(dispatch.spike_matmul(h, blk["w_fc1"]), lif,
                            packed=packed)
        if collect_stats:
            stats.append(h.dense())
        x_mp = x_mp + dispatch.spike_matmul(h, blk["w_fc2"])

    feats = lif_fire(x_mp, lif).mean(dim=(0, 2))      # rate + token avg
    logits = feats @ p["head"]
    return (logits, stats) if collect_stats else logits
