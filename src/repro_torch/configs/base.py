"""Model configuration schema.

Port of ``repro/configs/base.py``, copied: ``ModelConfig`` (one per
architecture, exact paper numbers) with its ``reduced()`` shrink used
by the CPU tests, ``MoEConfig`` and ``SSMConfig``, the shape cells
``ShapeCell`` / ``SHAPES``, ``long_context_ok`` (``base.py:143-148``) and
``RunConfig`` (``base.py:152-168``), field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                   # FFN hidden size per expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    n_shared_experts: int = 0       # dense experts always active (deepseek-style)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0     # chatglm3: 0.5 ("RoPE 2d")
    sliding_window: Optional[int] = None   # mixtral: 4096
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    # MoE dispatch locality groups (set ≥ data-parallel degree so routing
    # stays shard-local and only expert buffers cross the mesh)
    moe_dispatch_groups: int = 1
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block every `shared_every`
    # mamba layers, with per-invocation concat down-projections
    shared_every: int = 6
    # encdec (seamless): layers counted per stack
    n_dec_layers: Optional[int] = None
    cross_attention: bool = False
    # vlm (llava): stub patch-embedding prefix length
    n_prefix_embeds: int = 0
    # computational head padding: extra q-heads with zero wq/wo rows so
    # the head dim shards on the production mesh (outputs are unchanged —
    # zero wo rows drop the dummy heads). llava: 56 → 64.
    pad_heads_to: Optional[int] = None
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"      # dense | chunked
    attn_chunk: int = 2048
    remat: str = "selective"        # none | full | selective
    scan_layers: bool = True
    # --- notes for the roofline table ---
    approx_params: Optional[float] = None   # filled by param counter

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_q_heads(self) -> int:
        """Compute-time q-head count (≥ n_heads when padded for sharding)."""
        return self.pad_heads_to or self.n_heads

    def reduced(self) -> "ModelConfig":
        """Smoke-test shrink of the same family: tiny widths/layers/experts,
        same code paths."""
        kw = dict(
            n_layers=min(self.n_layers, 4) if self.family != "hybrid" else 8,
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2))
            if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            n_prefix_embeds=8 if self.family == "vlm" else 0,
            pad_heads_to=None,
            attn_impl="dense",
            attn_chunk=64,
            remat="none",
        )
        if self.moe is not None:
            # capacity_factor 4.0: smoke tests verify routing/dispatch
            # mechanics drop-free; the drop path has its own unit test.
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2),
                                  d_expert=64, capacity_factor=4.0,
                                  n_shared_experts=min(
                                      self.moe.n_shared_experts, 1))
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, chunk=16,
                                  d_conv=self.ssm.d_conv)
        if self.n_dec_layers is not None:
            kw["n_dec_layers"] = min(self.n_dec_layers, 2)
            kw["n_layers"] = min(self.n_layers, 2)
        if self.sliding_window is not None:
            kw["sliding_window"] = 32
        if self.family == "hybrid":
            kw["shared_every"] = 4
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode

    def reduced(self) -> "ShapeCell":
        return ShapeCell(self.name, min(self.seq_len, 64),
                         min(self.global_batch, 2), self.kind)


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# long_500k requires sub-quadratic attention: SSM / hybrid / sliding-window.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def long_context_ok(cfg: ModelConfig) -> bool:
    return cfg.family in SUBQUADRATIC_FAMILIES or cfg.sliding_window is not None


@dataclass(frozen=True)
class RunConfig:
    """Execution-level knobs (sharding / optimizer / fault tolerance)."""
    fsdp: bool = False              # shard weights over the data axis too
    zero1: bool = False             # shard ONLY optimizer state + grad
                                    # accumulators over data (no per-µb
                                    # weight re-gather, unlike fsdp)
    seq_shard_activations: bool = False   # SP for long prefill
    microbatches: int = 1           # gradient accumulation (activation mem ÷ n)
    optimizer: str = "adamw"        # adamw | adafactor | adamw8bit
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: Optional[str] = None  # None | int8
    remat_override: Optional[str] = None
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
