"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1
shared expert, GQA kv=8 [arXiv:2501.kimi2 paper-table]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=112, rope_theta=50_000.0,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  capacity_factor=1.25, n_shared_experts=1),
)
