"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention 4096
[arXiv:2401.04088]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128, rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336,
                  capacity_factor=1.25),
)
