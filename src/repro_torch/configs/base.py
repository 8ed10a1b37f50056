"""Config schema: the `SpikingConfig` knobs and the paper CNNs'
`CNNLayer` / `CNNConfig`, with `repro`'s field names and defaults."""
from __future__ import annotations

import dataclasses
from typing import Tuple


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
                                # (not ported yet: raises, ROADMAP q1 #13)
    packed: bool = False        # uint32 words as inter-layer payload
                                # (inference only: the words carry no
                                # gradient)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


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
