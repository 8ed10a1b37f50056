"""Shared model layers: params as plain dicts of tensors, pure apply
functions: inits, RMS and layer norms, RoPE, the LIF fire helpers and
the MLP.
Spiking layers take and return an explicit leading T axis
(micro-timesteps); LIF is the only op that couples timesteps.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.events import EventTensor
from repro_torch.core.lif import LIFConfig
from repro_torch.optim.adamw import AdamWState


def dense_init(d_in: int, d_out: int, dtype=torch.float32, *,
               generator: torch.Generator, device="cuda") -> torch.Tensor:
    """Truncated-normal (±2 sigma) Glorot-scaled (d_in, d_out) weights in
    `dtype`, drawn in f32 on the generator's device and moved to `device`
    (CUDA unless asked otherwise; a CUDA request without a card raises).
    The SpikingFormer and CNN callers keep f32 and a CPU generator; the
    LM's pass bf16, `repro`'s default there."""
    return bank_init((), d_in, d_out, dtype, generator=generator,
                     device=device)


def bank_init(lead: tuple, d_in: int, d_out: int, dtype=torch.float32, *,
              generator: torch.Generator, device="cuda") -> torch.Tensor:
    """`lead` + (d_in, d_out) weights drawn as `dense_init` draws one
    matrix (an MoE's expert bank is `lead` = (n_experts,)). On the `meta`
    device nothing is drawn: shapes only, for `lm.param_count`."""
    dev = resolve_device(device)
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.empty(tuple(lead) + (d_in, d_out), dtype=torch.float32,
                    device=_draw_device(generator, dev))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dev, dtype)


def _draw_device(generator: torch.Generator, dev: torch.device):
    """Where weights are drawn: the generator's device, or `meta` (no
    values) when that is the target."""
    return dev if dev.type == "meta" else generator.device


def embed_init(vocab: int, d: int, dtype=torch.bfloat16, *,
               generator: torch.Generator, device="cuda") -> torch.Tensor:
    """(vocab, d) embedding: truncated normal (±2 sigma) times 0.02."""
    dev = resolve_device(device)
    w = torch.empty((vocab, d), dtype=torch.float32,
                    device=_draw_device(generator, dev))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * 0.02).to(dev, dtype)


# ------------------------------------------------------------------- norms
def rmsnorm_init(d: int, device="cuda") -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, returned in `x`'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm_init(d: int, device="cuda") -> dict:
    dev = resolve_device(device)
    return {"scale": torch.ones((d,), dtype=torch.float32, device=dev),
            "bias": torch.zeros((d,), dtype=torch.float32, device=dev)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in f32 (biased variance), returned in `x`'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float = 1e4) -> tuple:
    """positions (..., N) int -> (sin, cos), each (..., N, d_head / 2) f32.
    The frequencies are theta ** (arange(0, d_head, 2) / d_head) in f32."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=positions.device) / d_head
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x (..., N, H, d_head); sin / cos (..., N, d_head / 2), broadcast over
    the heads. The head dimension splits into two halves (not even and odd
    lanes); computed in f32 and returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def hybrid_scope(spiking_cfg):
    """Dispatch scope a model's apply body runs under.

    `SpikingConfig.hybrid=True` turns on density-adaptive routing
    (`dispatch.use_hybrid`): every matmul-form op that receives a carried
    occupancy map picks the event or the dense route per call from the
    calibrated cost model, on the card with no host read of the map. Off
    (the default), resolution is what it was."""
    if getattr(spiking_cfg, "hybrid", False):
        from repro_torch.kernels import dispatch
        return dispatch.use_hybrid()
    return contextlib.nullcontext()


def lif_fire(x: torch.Tensor, lif_cfg: LIFConfig) -> torch.Tensor:
    """Binarize pre-activations into spikes over the leading T axis,
    routed through the backend registry (the CUDA kernel on the card)."""
    from repro_torch.kernels import dispatch
    return dispatch.lif_scan(x, decay=lif_cfg.decay, v_th=lif_cfg.v_th,
                             soft_reset=lif_cfg.soft_reset,
                             surrogate_alpha=lif_cfg.surrogate_alpha)


def lif_fire_events(x: torch.Tensor, lif_cfg: LIFConfig,
                    packed: bool = False) -> EventTensor:
    """Fire AND carry the event metadata: the full-event producer. The
    fused kernel emits the (128, 128) per-tile occupancy map and its
    8-row chunk refinement while it writes the spikes; the returned
    `EventTensor` lets the next event op skip its occupancy pre-pass.

    `packed=True` makes uint32 words the payload: the kernel writes the
    words instead of f32 spikes (the maps as before), the returned
    EventTensor is packed-only (`spikes=None`), and dispatch routes it to
    the packed backends. Forward only: the words carry no gradient."""
    from repro_torch.kernels import dispatch
    s, occ, chunks = dispatch.lif_scan_occ(
        x, decay=lif_cfg.decay, v_th=lif_cfg.v_th,
        soft_reset=lif_cfg.soft_reset,
        surrogate_alpha=lif_cfg.surrogate_alpha, packed=packed)
    if packed:
        return EventTensor(None, occ, chunks=chunks, packed=s,
                           feature_size=x.shape[-1])
    return EventTensor(s, occ, chunks=chunks)


# --------------------------------------------------------------- the MLP
def mlp_init(d_model: int, d_ff: int, dtype=torch.bfloat16, *,
             generator: torch.Generator, device="cuda") -> dict:
    return {"w_gate": dense_init(d_model, d_ff, dtype, generator=generator,
                                 device=device),
            "w_up": dense_init(d_model, d_ff, dtype, generator=generator,
                               device=device),
            "w_down": dense_init(d_ff, d_model, dtype, generator=generator,
                                 device=device)}


def mlp_apply(p: dict, x, spiking: bool,
              lif_cfg: LIFConfig | None = None):
    """SwiGLU in dense mode; spike-gated two-matmul MLP in spiking mode.

    Spiking mode (x binary (T, ...)): the hidden drive x @ w_gate + x @
    w_up is fired through LIF and down-projected, so every matmul sees
    binary activations (the LIF threshold stands in for the SiLU gate).

    Full-event mode (x an `EventTensor`): both up-projections read the ONE
    carried occupancy map through the registry's `spike_matmul`, the
    hidden fire re-emits its map (`lif_fire_events`, packed words when
    the input is packed), and the down-projection consumes that map: no
    occupancy pre-pass inside the block."""
    if isinstance(x, EventTensor):
        from repro_torch.kernels import dispatch
        h = dispatch.spike_matmul(x, p["w_gate"]) + \
            dispatch.spike_matmul(x, p["w_up"])
        h = lif_fire_events(h, lif_cfg, packed=x.is_packed)
        return dispatch.spike_matmul(h, p["w_down"])
    if spiking:
        h = x @ p["w_gate"].to(x.dtype)
        h = h + x @ p["w_up"].to(x.dtype)
        h = lif_fire(h, lif_cfg)
        return h @ p["w_down"].to(h.dtype)
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (torch.nn.functional.silu(g.float()).to(x.dtype) * u) \
        @ p["w_down"].to(x.dtype)


def params_from_numpy(tree, device="cuda"):
    """A `repro` param tree (leaves passed through `np.asarray`) as port
    params on `device`: same nesting, same layouts, float32 tensors.
    `None` placeholders (VGG11's pooling slots) stay `None` and Python
    `int` / `bool` leaves (ResNet18's block `stride`) stay themselves. A
    `repro` AdamW state (`step`, `mu`, `nu`) comes across as the port's
    `AdamWState`, keeping an integer step and bfloat16 moments."""
    dev = resolve_device(device)
    if tree is None or isinstance(tree, (bool, int)):
        return tree
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == \
            AdamWState._fields:
        return AdamWState(
            step=torch.tensor(int(np.asarray(tree[0])), dtype=torch.int32,
                              device=dev),
            mu=params_from_numpy(tree[1], dev),
            nu=params_from_numpy(tree[2], dev))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
    arr = np.asarray(tree)
    out = torch.from_numpy(arr.astype(np.float32)).to(dev)
    # numpy has no bfloat16 of its own: such leaves arrive as ml_dtypes'
    # type, whose values f32 holds exactly, so the round trip is lossless.
    return out.to(torch.bfloat16) if arr.dtype.name == "bfloat16" else out


def params_to_numpy(tree):
    """Port params (or an `AdamWState`) as the same tree of numpy arrays;
    bfloat16 leaves come back as float32 (numpy has no bfloat16), `None`
    and `int` / `bool` leaves as themselves."""
    if tree is None or isinstance(tree, (bool, int)):
        return tree
    if isinstance(tree, AdamWState):
        return AdamWState(*(params_to_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
