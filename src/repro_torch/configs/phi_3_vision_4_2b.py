"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct]: 32L d3072
32H(kv32) d_ff 8192; CLIP frontend stubbed as precomputed patch embeds."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
    n_frontend_tokens=1024, rope_theta=1e4,
    spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
    n_frontend_tokens=8, remat="none", loss_chunk=16)
