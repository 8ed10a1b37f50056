"""xlstm-350m [arXiv:2405.04517]: 24L d1024 4H, sLSTM+mLSTM 1:7 blocks,
vocab 50304. Attention-free: SDSA inapplicable (DESIGN §Arch-applicability);
the LIF/full-event activation path still applies."""
from .base import LMConfig, SpikingConfig, XLSTMSpec

CONFIG = LMConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    xlstm=XLSTMSpec(period=8, slstm_index=7),
    spiking=SpikingConfig(t_steps=1),
)

# One shortened period still covers both block kinds (mLSTM + sLSTM) at
# a quarter of the distinct-block compile cost of period=8.
REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512,
    xlstm=XLSTMSpec(period=2, slstm_index=1),
    remat="none", loss_chunk=16)
