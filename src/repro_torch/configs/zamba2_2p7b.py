"""zamba2-2.7b [hybrid] — Mamba2 trunk + shared attention block every 6
layers with concat down-projection [arXiv:2411.15242]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80, shared_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=128),
)
