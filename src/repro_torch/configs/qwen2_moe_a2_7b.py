"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H(kv16)
d_ff 1408/expert, 4 shared + 60 routed top-4."""
from .base import LMConfig, MoESpec, SpikingConfig

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936,
    moe=MoESpec(n_experts=60, top_k=4, d_ff_expert=1408, n_shared=4),
    rope_theta=1e6, spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
    moe=MoESpec(n_experts=8, top_k=4, d_ff_expert=32, n_shared=2),
    remat="none", loss_chunk=16)
