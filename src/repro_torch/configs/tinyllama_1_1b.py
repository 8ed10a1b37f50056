"""tinyllama-1.1b [arXiv:2401.02385]: 22L d2048 32H(kv4) d_ff 5632."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=5632, vocab=32000,
    rope_theta=1e4, spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    remat="none", loss_chunk=16)
