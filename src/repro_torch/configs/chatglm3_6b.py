"""chatglm3-6b [dense] — GQA kv=2, 2d-RoPE (partial rotary 0.5)
[arXiv:2406.12793]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, head_dim=128, rope_theta=10_000.0,
    partial_rotary=0.5,
)
