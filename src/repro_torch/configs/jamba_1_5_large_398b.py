"""jamba-1.5-large-398b [arXiv:2403.19887]: 72L d8192 64H(kv8) d_ff 24576,
Mamba+attn 1:7 interleave, MoE 16e top-2 on alternate layers."""
from .base import HybridSpec, LMConfig, MoESpec, SpikingConfig

CONFIG = LMConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576, moe_every=2),
    hybrid=HybridSpec(period=8, attn_index=3),
    rope_theta=1e6,
    spiking=SpikingConfig(t_steps=1),   # SSM states keep T=1 (DESIGN §4)
    fsdp=True, microbatches=8, opt_state_dtype="bfloat16",
)

# One shortened period still covers every block kind (mamba + attn, and
# moe_every=2 puts a dense ffn on one and MoE on the other) at a quarter
# of the distinct-block compile cost of period=8.
REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=32, moe_every=2),
    hybrid=HybridSpec(period=2, attn_index=1),
    fsdp=False, microbatches=1, remat="none", loss_chunk=16)
