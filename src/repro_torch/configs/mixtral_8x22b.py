"""mixtral-8x22b [arXiv:2401.04088]: 56L d6144 48H(kv8) d_ff 16384,
8 experts top-2, sliding-window attention."""
from .base import LMConfig, MoESpec, SpikingConfig

CONFIG = LMConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768,
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
    sliding_window=4096, rope_theta=1e6,
    spiking=SpikingConfig(t_steps=2), fsdp=True, microbatches=4,
    opt_state_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=64),
    sliding_window=8, fsdp=False, microbatches=1, remat="none",
    loss_chunk=16)
