"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]:
88L d12288 96H(kv8) d_ff 28672."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="mistral-large-123b", family="dense", n_layers=88, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=28672, vocab=32768,
    rope_theta=1e6, spiking=SpikingConfig(t_steps=2),
    fsdp=True, microbatches=4, opt_state_dtype="bfloat16",
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    fsdp=False, microbatches=1, remat="none", loss_chunk=16)
