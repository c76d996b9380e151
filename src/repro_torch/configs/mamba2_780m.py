"""mamba2-780m [ssm] — attention-free SSD (state-space duality)
[arXiv:2405.21060]."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, head_dim=64, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk=256),
)
