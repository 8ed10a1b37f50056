"""qwen3-4b [hf:Qwen/Qwen3-8B family]: 36L d2560 32H(kv8) d_ff 9728,
qk_norm, head_dim 128 (decoupled from d_model/H)."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, d_ff=9728, vocab=151936, d_head=128,
    qk_norm=True, rope_theta=1e6, spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512, d_head=16,
    remat="none", loss_chunk=16)
