"""What the work costs: each kernel's bytes and operations, and the
LM's analytic step model.

Port of ``repro/roofline/analysis.py`` (``Roofline``, ``active_params``,
``model_flops_for_cell``, ``estimate_memory``).  The reference counts a
stage's flops and bytes by parsing the compiled XLA HLO text
(``hlo_cost.analyze_hlo``) and its collective bytes the same way
(``analysis.parse_collectives``).  The port compiles no HLO: its kernels
are hand-written, so their work is counted from their shapes here, one
count per kernel, which ``chip_smoke.py``'s bounds, the pipeline report
and the tests read:

* the query kernels (``pdist``, ``pdist_lp``, ``range_filter``,
  ``rankeval``, ``pdist_rankeval``, ``knn_loop_cond``): every input read
  once, every output written once, and the f32 operations of their fixed
  operation order (``rank_ops`` a rank evaluation);
* ``flash_work``: the attention function's own work over its live (q, k)
  pairs, unpadded.

Each ``*_work`` returns ``(bytes, flops)``; ``hw.bound`` turns them into
the least time.  The dry-run's step model (``launch/dryrun.py``) has no
compiled program either: :class:`Roofline` takes the model flops
(6·N·D) and the memory model's bytes a step, at the H100's ceilings;
compiled flops and bytes and collective bytes are not measured.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import hw

RANK_VALUES_PER_GROUP = 3       # lo, hi, n of each group's model


# ------------------------------------------------------------ the kernels
def rank_ops(n_coef: int) -> int:
    """f32 operations of one rank_math evaluation: normalize (6),
    Clenshaw (3 per coefficient past the first, +4), rank and ring id
    (10)."""
    return 6 + 3 * (n_coef - 1) + 4 + 10


def pdist_work(nq: int, npts: int, d: int,
               point_bytes: int = 4) -> tuple[float, float]:
    """sql2 distances (nq, np): q and p read, the f32 matrix written;
    2d + 4 operations a cell and 2d a row's norm."""
    return (4.0 * nq * d + float(point_bytes) * npts * d + 4.0 * nq * npts,
            float(nq * npts * (2 * d + 4) + 2 * d * (nq + npts)))


def pdist_lp_work(groups: int, nq: int, npts: int,
                  d: int) -> tuple[float, float]:
    """L1 / L-infinity distances of ``groups`` (nq, np) blocks: 3
    operations a term (subtract, absolute value, add or max)."""
    return (4.0 * (groups * nq * d + groups * npts * d
                   + groups * nq * npts),
            3.0 * d * groups * nq * npts)


def range_filter_work(nq: int, npts: int, d: int,
                      point_bytes: int = 4) -> tuple[float, float]:
    """The ball test over (nq, np): q, r and p read, the uint8 mask and
    the int32 count per 128-point tile written; pdist's operations and
    the compare."""
    return (4.0 * (nq * d + nq) + float(point_bytes) * npts * d
            + float(nq * npts) + 4.0 * nq * (-(-npts // 128)),
            float(nq * npts * (2 * d + 5) + 2 * d * (nq + npts)))


def rankeval_work(g: int, b: int, n_coef: int) -> tuple[float, float]:
    """(G, B) values through their groups' models: x, the coefficients
    and lo / hi / n read, rank and ring id written."""
    return (4.0 * (g * b + g * n_coef + RANK_VALUES_PER_GROUP * g)
            + 8.0 * g * b,
            float(g * b * rank_ops(n_coef)))


def pdist_rankeval_work(b: int, g: int, d: int,
                        n_coef: int) -> tuple[float, float]:
    """The fused plan stage: q, the pivots, the models and rg read, dq
    (B, G) f32 and two (G, B) int32 rank tables written; the distance,
    its square root and two rank evaluations a pair."""
    return (4.0 * (b * d + g * d + g * n_coef + RANK_VALUES_PER_GROUP * g
                   + b) + 4.0 * b * g + 8.0 * g * b,
            float(2 * d * (b + g)
                  + b * g * (2 * d + 4 + 3 + 2 * rank_ops(n_coef))))


def knn_loop_cond_work(b: int) -> tuple[float, float]:
    """The kNN loop's condition: B done flags and three int32 counters."""
    return float(b + 4 * 3), 0.0


def flash_work(b, hq, hk, d, sq, kv_len, causal, window, itemsize=2):
    """(live pairs per head, flops, bytes) of the attention function
    itself: the (q, k) pairs its mask keeps over the real ``sq`` query
    rows and ``kv_len`` keys, 4 flops a pair and head-dim element (Q K^T
    and P V once each), and q, k, v read and o written once, unpadded.
    What the kernel adds (padded rows and keys, the tensor-core body's
    second P V pass) is its own cost, not the bound's."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(kv_len)[None, :]
    ok = np.ones((sq, kv_len), bool)
    if causal:
        ok &= qpos >= kpos
    if window is not None:
        ok &= qpos - kpos < window
    live = int(ok.sum())
    flops = 4.0 * b * hq * d * live
    nbytes = float(itemsize) * (2 * b * hq * sq * d + 2 * b * hk * kv_len * d)
    return live, flops, nbytes


# ------------------------------------------------------- the LM's steps
@dataclass
class Roofline:
    """A step's lower bound at the H100's ceilings from the analytic
    counts: ``flops`` (the model flops a device) and ``hbm_bytes`` (the
    memory model's bytes a device, each touched at least once a step).
    The compiled program's flops and bytes and the collective bytes are
    not measured (the port compiles no HLO)."""
    flops: float
    hbm_bytes: float
    model_flops: float

    @property
    def t_compute(self) -> float:
        return self.flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / hw.HBM_BW

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap model: the larger term."""
        return max(self.t_compute, self.t_memory)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the bound."""
        t = self.step_time_lower_bound
        return (self.model_flops / t) / hw.PEAK_FLOPS_BF16 if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "model_flops_per_dev": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time_lower_bound,
            "mfu_bound": self.mfu_bound,
        }


def _flat_specs(specs, path=()):
    """(path, ParamSpec) in sorted-key order (JAX's order for dicts)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _flat_specs(specs[k], path + (k,))]
    return [(path, specs)]


def active_params(cfg, specs) -> tuple:
    """(N_total, N_active): MoE expert tensors scaled by (top_k/E);
    the embedding gather table excluded from N_active (the 6·N·D
    convention counts matmul-participating params; tied embeddings and
    lm_head do participate)."""
    total = 0
    active = 0
    for path, spec in _flat_specs(specs):
        n = int(np.prod(spec.shape))
        total += n
        name = path[-1] if path else ""
        if name == "embed" and not cfg.tie_embeddings:
            continue
        if name in ("we1", "we2", "we3") and cfg.moe is not None:
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    return total, int(active)


def model_flops_for_cell(cfg, specs, cell, n_chips: int) -> float:
    """Per-device MODEL_FLOPS for one step of the given shape cell."""
    _, n_active = active_params(cfg, specs)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens / n_chips
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens / n_chips
    return 2.0 * n_active * cell.global_batch / n_chips


def estimate_memory(cfg, run, specs, cell, mesh, rules,
                    opt_state_abstract=None, cache_abstract=None) -> dict:
    """Analytical per-device memory model (bytes), the reference's: exact
    on the static terms (params, optimizer, cache via the sharding
    descriptions' ``shard_shape``) and napkin math on the dynamic ones
    (activation residuals per remat policy, logits, workspace)."""
    from ..sharding.logical import guarded_sharding
    from ..train.optim import tree_leaves

    def shard_bytes(shape, axes, dtype_bytes):
        sh = guarded_sharding(tuple(shape), axes, rules, mesh)
        local = sh.shard_shape(tuple(shape))
        return int(np.prod(local)) * dtype_bytes if local else dtype_bytes

    flat = [s for _, s in _flat_specs(specs)]
    dt_b = 2 if cfg.dtype == "bfloat16" else 4
    params_b = 0
    for s in flat:
        b = 2 if (s.dtype or cfg.dtype) == "bfloat16" else 4
        params_b += shard_bytes(s.shape, s.axes, b)

    out = {"params": params_b}
    if cell.kind == "train":
        grads_b = 0
        for s in flat:
            grads_b += shard_bytes(s.shape, s.axes, 4)
        if run.zero1:
            dp_ext = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
            grads_b //= dp_ext
        out["grads"] = grads_b
        if run.optimizer == "adamw":
            out["opt"] = 2 * grads_b
        elif run.optimizer == "adafactor":
            out["opt"] = grads_b // 512
        else:
            out["opt"] = grads_b // 2 + grads_b // 128
        bsh = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        b_loc = max(1, cell.global_batch // bsh) // max(run.microbatches, 1)
        b_loc = max(b_loc, 1)
        s_loc = cell.seq_len
        if rules.get("seq") == "model":
            s_loc //= mesh.shape.get("model", 1)
        hidden = b_loc * s_loc * cfg.d_model * dt_b
        n_res = cfg.n_layers + (cfg.n_dec_layers or 0)
        if cfg.remat == "full":
            resid = n_res * hidden
        elif cfg.remat == "selective":
            resid = n_res * hidden * 6
        else:
            resid = n_res * hidden * 12
        out["residuals"] = int(resid)
        vshard = mesh.shape.get("model", 1) \
            if cfg.vocab % mesh.shape.get("model", 1) == 0 else 1
        out["logits"] = int(b_loc * s_loc * cfg.vocab / vshard * 4)
        out["workspace"] = int(8 * hidden)
    else:
        bsh = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        b_loc = max(1, cell.global_batch // bsh)
        if cell.kind == "prefill":
            s_loc = cell.seq_len
            hidden = b_loc * s_loc * cfg.d_model * dt_b
            out["workspace"] = int(6 * hidden)
        cache_b = 0
        if cache_abstract is not None:
            for leaf in tree_leaves(cache_abstract):
                sh = getattr(leaf, "sharding", None)
                shape = tuple(leaf.shape)
                local = sh.shard_shape(shape) if sh is not None else shape
                cache_b += int(np.prod(local)) * leaf.element_size()
        out["cache"] = cache_b
        vshard = mesh.shape.get("model", 1) \
            if cfg.vocab % mesh.shape.get("model", 1) == 0 else 1
        out["logits"] = int(b_loc * cfg.vocab / vshard * 4)
        out.setdefault("workspace", int(32 * b_loc * cfg.d_model * dt_b))
    out["total"] = int(sum(out.values()))
    return out


__all__ = ["rank_ops", "pdist_work", "pdist_lp_work", "range_filter_work",
           "rankeval_work", "pdist_rankeval_work", "knn_loop_cond_work",
           "flash_work", "Roofline", "active_params",
           "model_flops_for_cell", "estimate_memory"]
