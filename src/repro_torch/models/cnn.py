"""The paper's own SCNN workloads: spiking VGG11, ResNet18, SegNet, the
port of `repro.models.cnn`.

LIF neurons (tau=0.5), T=4 timesteps, a direct-coded first layer (OPT1),
event-driven convs (OPT2) and an EAFC avgpool+FC head (OPT3). Residual
connections add membrane drives before the fire stage (the Residual Spike
SRAM path of Fig. 3).

Every conv (stem, strided downsamples, and the segmentation decoder's
transposed convs) routes through the backend registry (`econv` / `tconv`
ops) with micro-timesteps folded into the batch axis. The first layer
eats the direct-coded (multi-bit) drive; the kernels count its nonzeros
for the map, never its sum. From the first fire on the stream is
full-event: each fire emits spikes with their maps, pooling and strided
convs carry them, and the next conv consumes them. With
`SpikingConfig(packed=True)` the fires emit uint32 words instead, pooling
ORs them and the convs take them; the EAFC head, ResNet18's identity
shortcut and SegNet's transposed convs unpack explicitly (`.dense()`).

The params are plain dicts with the same tree and layouts as `repro`'s
(VGG11's pooling slots are `None`, ResNet18's blocks carry an `int`
stride), so `models.layers.params_from_numpy` brings JAX params across.
The apply functions are differentiable; inference callers enter
`torch.inference_mode()` themselves. `collect_stats=True` also returns
the spike map of every fired layer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CNNConfig, CNNLayer
from repro_torch.core.direct_coding import quantize
from repro_torch.core.eafc import eafc
from repro_torch.core.econv import conv_transpose, econv
from repro_torch.core.events import EventTensor, max_pool_events
from repro_torch.core.lif import LIFConfig
from .layers import hybrid_scope, lif_fire_events

Params = Dict[str, Any]


def _fire(drive: torch.Tensor, lif: LIFConfig,
          packed: bool = False) -> EventTensor:
    """Fire stage with fused metadata emission: spikes and occupancy
    leave the LIF together (`lif_scan_occ`), so the next conv's event
    kernel consumes the carried map instead of re-scanning. `packed=True`
    emits uint32 words as the payload (no f32 spikes between layers)."""
    return lif_fire_events(drive, lif, packed=packed)


def _conv_seq(s, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(T,B,H,W,C) drive through the registry `econv` op, T folded into
    the batch. `s` may be an `EventTensor`: the fold keeps the trailing
    channel axis, so the carried map survives into the conv."""
    t, b = s.shape[:2]
    out = econv(s.reshape((t * b,) + tuple(s.shape[2:])), w, stride=stride)
    return out.reshape((t, b) + tuple(out.shape[1:]))


def _tconv_seq(s, w: torch.Tensor, stride: int) -> torch.Tensor:
    """(T,B,H,W,C) spikes through the registry `tconv` (transposed conv).
    Zero-insertion moves every event, so `tconv` takes the dense view: a
    packed payload is unpacked there (`as_spikes`, the explicit
    `.dense()`)."""
    t, b = s.shape[:2]
    out = conv_transpose(s.reshape((t * b,) + tuple(s.shape[2:])), w,
                         stride=stride)
    return out.reshape((t, b) + tuple(out.shape[1:]))


def _coded_drive(x: torch.Tensor, cfg: CNNConfig) -> torch.Tensor:
    """The direct-coded input (OPT1), the same drive at every timestep."""
    q, scale = quantize(x.float(), cfg.direct_coding_bits)
    coded = q.to(torch.float32) * scale
    return coded.unsqueeze(0).expand((cfg.spiking.t_steps,) +
                                     tuple(x.shape))


def _lif(cfg: CNNConfig) -> LIFConfig:
    return LIFConfig(decay=cfg.spiking.lif_decay, v_th=cfg.spiking.lif_vth)


def _check_device(p: Params, x: torch.Tensor) -> None:
    leaf = p["fc"] if "fc" in p else p["convs"][0]
    if x.device != leaf.device:
        raise ValueError(f"input on {x.device}, params on {leaf.device}")


# ------------------------------------------------------- model definitions
VGG11_LAYERS: Tuple[CNNLayer, ...] = (
    CNNLayer("conv", 64), CNNLayer("maxpool"),
    CNNLayer("conv", 128), CNNLayer("maxpool"),
    CNNLayer("conv", 256), CNNLayer("conv", 256), CNNLayer("maxpool"),
    CNNLayer("conv", 512), CNNLayer("conv", 512), CNNLayer("maxpool"),
    CNNLayer("conv", 512), CNNLayer("conv", 512),
)

SEGNET_LAYERS: Tuple[CNNLayer, ...] = (   # 8C3-16C3-32C3-32C3-16TC3-2TC3
    CNNLayer("conv", 8), CNNLayer("conv", 16, stride=2),
    CNNLayer("conv", 32, stride=2), CNNLayer("conv", 32),
    CNNLayer("tconv", 16, stride=2), CNNLayer("tconv", 2, stride=2),
)

RESNET18_STAGES = ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2))


def _conv_init(k: int, ci: int, co: int, *, generator: torch.Generator,
               device="cuda") -> torch.Tensor:
    """He-scaled normal (k, k, ci, co) HWIO conv weights, drawn on the CPU
    and moved to `device` (CUDA unless asked otherwise; a CUDA request
    without a card raises)."""
    dev = resolve_device(device)
    scale = (2.0 / (k * k * ci)) ** 0.5
    w = torch.randn((k, k, ci, co), generator=generator) * scale
    return w.to(dev)


def _fc_init(d_in: int, n_out: int, *, generator: torch.Generator,
             device) -> torch.Tensor:
    w = torch.randn((d_in, n_out), generator=generator) * (1.0 / d_in) ** 0.5
    return w.to(device)


# ------------------------------------------------------------------- VGG11
def vgg11_init(cfg: CNNConfig, *, generator: torch.Generator | None = None,
               device="cuda") -> Params:
    """Random VGG11 params drawn from `generator` on the CPU (so a seed
    gives the same weights on every device), then moved to `device`."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    p: Params = {"convs": []}
    ci, spatial = cfg.in_ch, cfg.img
    for layer in VGG11_LAYERS:
        if layer.kind == "conv":
            p["convs"].append(_conv_init(layer.kernel, ci, layer.out_ch,
                                         generator=g, device=dev))
            ci = layer.out_ch
        else:
            p["convs"].append(None)
            spatial //= 2
    pooled = spatial // cfg.fc_pool
    p["fc"] = _fc_init(pooled * pooled * ci, cfg.n_classes, generator=g,
                       device=dev)
    return p


def vgg11_apply(cfg: CNNConfig, p: Params, x: torch.Tensor,
                collect_stats: bool = False):
    """x: (B, H, W, C) image -> logits (B, n_classes) [, spike maps]."""
    _check_device(p, x)
    with hybrid_scope(cfg.spiking):
        return _vgg11_body(cfg, p, x, collect_stats)


def _vgg11_body(cfg, p, x, collect_stats):
    lif = _lif(cfg)
    s = _coded_drive(x, cfg)
    stats: List[torch.Tensor] = []
    for layer, w in zip(VGG11_LAYERS, p["convs"]):
        if layer.kind == "maxpool":
            s = max_pool_events(s, layer.pool)     # the carried map survives
            continue
        s = _fire(_conv_seq(s, w), lif, cfg.spiking.packed)
        if collect_stats:
            stats.append(s.dense())
    logits = _eafc_head(s.dense(), p["fc"], cfg.fc_pool)
    return (logits, stats) if collect_stats else logits


def _eafc_head(s: torch.Tensor, w_fc: torch.Tensor,
               pool: int) -> torch.Tensor:
    """EAFC head (OPT3) over every timestep of (T,B,H,W,C) spikes, then
    the rate average over T."""
    t, b = s.shape[:2]
    out = eafc(s.reshape((t * b,) + tuple(s.shape[2:])), w_fc, pool)
    return out.reshape(t, b, -1).mean(dim=0)


# ---------------------------------------------------------------- ResNet18
def resnet18_init(cfg: CNNConfig, *,
                  generator: torch.Generator | None = None,
                  device="cuda") -> Params:
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    p: Params = {"stem": _conv_init(3, cfg.in_ch, 64, generator=g,
                                    device=dev), "blocks": []}
    ci = 64
    for co, n_blocks, stride in RESNET18_STAGES:
        for b in range(n_blocks):
            s0 = stride if b == 0 else 1
            blk = {"conv1": _conv_init(3, ci, co, generator=g, device=dev),
                   "conv2": _conv_init(3, co, co, generator=g, device=dev),
                   "stride": s0}
            if s0 != 1 or ci != co:
                blk["proj"] = _conv_init(1, ci, co, generator=g, device=dev)
            p["blocks"].append(blk)
            ci = co
    pooled = cfg.img // 8 // cfg.fc_pool
    p["fc"] = _fc_init(pooled * pooled * ci, cfg.n_classes, generator=g,
                       device=dev)
    return p


def resnet18_apply(cfg: CNNConfig, p: Params, x: torch.Tensor,
                   collect_stats: bool = False):
    _check_device(p, x)
    with hybrid_scope(cfg.spiking):
        return _resnet18_body(cfg, p, x, collect_stats)


def _resnet18_body(cfg, p, x, collect_stats):
    lif = _lif(cfg)
    packed = cfg.spiking.packed
    s = _fire(_conv_seq(_coded_drive(x, cfg), p["stem"]), lif, packed)
    stats: List[torch.Tensor] = [s.dense()] if collect_stats else []
    for blk in p["blocks"]:
        st0 = blk["stride"]
        h = _fire(_conv_seq(s, blk["conv1"], stride=st0), lif, packed)
        h2 = _conv_seq(h, blk["conv2"])
        # Residual Spike SRAM path: shortcut drives are added pre-fire (the
        # sum is membrane drive, not spikes; the map re-emits at _fire).
        # The identity shortcut is a drive summand: an explicit `.dense()`.
        short = _conv_seq(s, blk["proj"], stride=st0) if "proj" in blk \
            else s.dense()
        s = _fire(h2 + short, lif, packed)
        if collect_stats:
            stats.append(s.dense())
    logits = _eafc_head(s.dense(), p["fc"], cfg.fc_pool)
    return (logits, stats) if collect_stats else logits


# ------------------------------------------------------------------ SegNet
def segnet_init(cfg: CNNConfig, *, generator: torch.Generator | None = None,
                device="cuda") -> Params:
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator()
    p: Params = {"convs": []}
    ci = cfg.in_ch
    for layer in SEGNET_LAYERS:
        p["convs"].append(_conv_init(layer.kernel, ci, layer.out_ch,
                                     generator=g, device=dev))
        ci = layer.out_ch
    return p


def segnet_apply(cfg: CNNConfig, p: Params, x: torch.Tensor,
                 collect_stats: bool = False):
    """x: (B, H, W, C) -> per-pixel logits (B, H, W, 2) [, spike maps]."""
    _check_device(p, x)
    with hybrid_scope(cfg.spiking):
        return _segnet_body(cfg, p, x, collect_stats)


def _segnet_body(cfg, p, x, collect_stats):
    lif = _lif(cfg)
    s = _coded_drive(x, cfg)
    stats: List[torch.Tensor] = []
    last = len(SEGNET_LAYERS) - 1
    for i, (layer, w) in enumerate(zip(SEGNET_LAYERS, p["convs"])):
        if layer.kind == "conv":
            drive = _conv_seq(s, w, stride=layer.stride)
        else:       # transposed conv (decoder upsampling): registry `tconv`
            drive = _tconv_seq(s, w, stride=layer.stride)
        if i == last:                 # un-fired logits, averaged over T
            logits = drive.mean(dim=0)
            return (logits, stats) if collect_stats else logits
        s = _fire(drive, lif, cfg.spiking.packed)
        if collect_stats:
            stats.append(s.dense())
    raise AssertionError("unreachable")
