"""seamless-m4t-large-v2 [audio] — enc-dec backbone (24+24 layers); the
modality frontend is a stub providing (B, S_frames, d_model) embeddings
[arXiv:2308.11596]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_dec_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64, cross_attention=True,
)
