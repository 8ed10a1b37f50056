"""whisper-medium [arXiv:2212.04356]: enc-dec 24L d1024 16H d_ff 4096,
conv audio frontend stubbed as precomputed frame embeddings (1500 frames)."""
from .base import LMConfig, SpikingConfig

CONFIG = LMConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865,
    encoder_decoder=True, n_encoder_layers=24, encoder_seq=1500,
    rope_theta=1e4, spiking=SpikingConfig(t_steps=2),
)

REDUCED = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    vocab=512, encoder_seq=24, remat="none", loss_chunk=16)
