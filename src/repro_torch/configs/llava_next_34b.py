"""llava-next-34b [vlm] — anyres tiling; backbone only, the vision tower
is a stub providing (B, 2304, d_model) patch embeddings
[hf:llava-hf/llava-v1.6]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128, rope_theta=5_000_000.0,
    n_prefix_embeds=2304,
    # 56 q-heads don't shard 16-way; pad to 64 with zero wq/wo rows
    # (outputs unchanged, attention shards instead of replicating 16x)
    pad_heads_to=64,
)
