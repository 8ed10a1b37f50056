"""Config schema with `repro`'s field names and defaults: the
`SpikingConfig` knobs, the LM architectures' `LMConfig` (with the
data-only `MoESpec`, `HybridSpec` and `XLSTMSpec` it names) and the
assigned `ShapeSpec` cells, and the paper CNNs' `CNNLayer` / `CNNConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SpikingConfig:
    """ExSpike technique knobs; field names and defaults as in `repro`."""
    enabled: bool = True
    t_steps: int = 2            # micro-timesteps per token (paper CNNs: 4)
    lif_decay: float = 0.5      # paper: tau = 0.5
    lif_vth: float = 1.0
    sdsa_mode: str = "or"       # "or" (paper Fig. 6) | "sum" (trainable)
    apec_group: int = 2         # paper's default G2
    hybrid: bool = False        # density-adaptive dense/event routing
                                # (`kernels.dispatch.use_hybrid`)
    packed: bool = False        # uint32 words as inter-layer payload
                                # (inference only: the words carry no
                                # gradient)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts FFN layout, built by `models/moe.py`."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # always-on shared experts (qwen2-moe)
    moe_every: int = 1          # MoE FFN on layers l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    pad_experts_to: int = 0     # pad the expert bank (not the router)

    @property
    def bank_size(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """jamba: 1 attention per `period` layers, rest Mamba (data only)."""
    period: int = 8
    attn_index: int = 3
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    """xLSTM[m:s] interleave: one sLSTM per `period` (data only)."""
    period: int = 8
    slstm_index: int = 7


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One LM architecture, field for field as `repro.configs.base`. The
    distribution and memory knobs are kept so the configs compare equal;
    the port reads only the model's shape and `spiking`."""
    name: str
    family: str                 # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None
    moe: Optional[MoESpec] = None
    hybrid: Optional[HybridSpec] = None
    xlstm: Optional[XLSTMSpec] = None
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0        # stub frontend positions feeding the encoder
    n_frontend_tokens: int = 0  # stub embeds prepended to the decoder (vlm)
    rope_theta: float = 1e6
    spiking: SpikingConfig = SpikingConfig()
    remat: str = "full"         # none|full|dots
    microbatches: int = 1
    opt_state_dtype: str = "float32"
    fsdp: bool = False
    tp2d: bool = False
    moe_dispatch_groups: int = 1
    moe_shard_map: bool = False
    decode_masked_update: bool = True
    pure_fsdp: bool = False
    loss_chunk: int = 512

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train|prefill|decode|long_decode


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "long_decode"),
)


@dataclasses.dataclass(frozen=True)
class CNNLayer:
    kind: str                   # conv|tconv|maxpool|avgpool
    out_ch: int = 0
    kernel: int = 3
    stride: int = 1
    pool: int = 2


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Paper's own workloads (VGG11/ResNet18/SegNet)."""
    name: str
    layers: Tuple[CNNLayer, ...]
    in_ch: int = 3
    img: int = 32
    n_classes: int = 10
    fc_pool: int = 2            # avgpool before FC (EAFC target)
    direct_coding_bits: int = 8
    spiking: SpikingConfig = SpikingConfig(t_steps=4)
