"""Config schema (the SpikingConfig subset the SpikingFormer path reads)."""
from __future__ import annotations

import dataclasses


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
                                # (not ported yet: raises, ROADMAP q1 #12)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
