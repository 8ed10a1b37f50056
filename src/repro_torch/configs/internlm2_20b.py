"""internlm2-20b [arXiv:2403.17297]: 48L d6144 48H(kv8) d_ff 16384 GQA."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="internlm2-20b", family="dense", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92544,
    rope_theta=1e6, spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    remat="none", loss_chunk=16)
