"""The data-parallel training step over W = 2 gloo ranks on the CPU.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on both ranks; each rank passes its ``DataShard`` block of
the global batch.  The parent holds the results to:

* the reference's one-device jitted step on the concatenated global
  batch, at ``test_train_step_matches_reference``'s bars (metrics 1e-5
  relative, every parameter within ``SCALED`` of its scale): reduced
  llama3-8b, a reduced MoE (mixtral, dispatch groups 2, capacity factor
  1.25, with drops) and encdec, labels masked unevenly across the
  ranks, plain DP x {adamw, adafactor, adamw8bit} and ZeRO-1 x {adamw,
  adamw8bit}, 1 and 2 microbatches;
* the port's own one-process step on the same inputs at a tighter f32
  bar (``PORT_METRIC_RTOL``, ``PORT_PARAM_REL``), int8 compression on
  too (its uniforms are the port's, not the reference's, so int8 is held
  to the port only).

Besides: the per-rank means the reference does not compute (the
"rank-mean trap") part from its NLL and load balance; ZeRO-1's optimizer
state and accumulator bytes on each rank equal ``abstract_state``'s and
the gradient shardings' shard bytes; a W = 2 ZeRO-1 checkpoint restores
into one process and back and continues bit-equal; the fault loop under
the group restores both ranks after one rank's failure; the elastic
gather and reshard; and the refusals.  ``jax`` and ``repro`` are imported
in the parent's fixtures only, so the ranks start without them.  The
``gpu`` test runs two NCCL ranks where there are two cards.
"""
import dataclasses
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataShard, microbatch_rows, shard_rows
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import zoo
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import FaultConfig, run_training
from repro_torch.sharding import collective
from repro_torch.sharding.logical import LogicalMesh, default_rules
from repro_torch.train import optim
from repro_torch.train.step import (abstract_state, build_train_step,
                                    init_state, zero1_grad_shardings)

W = 2
SCALED = 2e-3                   # as tests/test_torch_train.py
METRIC_RTOL = 1e-5              # against the reference
PORT_METRIC_RTOL = 1e-6         # against the port's one-process step
PORT_PARAM_REL = 2e-5           # of each parameter's scale, ditto
LR = 5e-3
CF = 1.25                       # the MoE capacity factor (drops)
# (id, arch, mode, optimizer, microbatches, int8)
CASES = [
    *[(f"llama-plain-{o}-mb{mb}", "llama3-8b", "plain", o, mb, False)
      for o in ("adamw", "adafactor", "adamw8bit") for mb in (1, 2)],
    *[(f"llama-zero1-{o}-mb{mb}", "llama3-8b", "zero1", o, mb, False)
      for o in ("adamw", "adamw8bit") for mb in (1, 2)],
    ("llama-plain-adamw-mb2-int8", "llama3-8b", "plain", "adamw", 2, True),
    ("llama-zero1-adamw8bit-mb2-int8", "llama3-8b", "zero1", "adamw8bit", 2,
     True),
    ("moe-plain-adamw-mb2", "mixtral-8x7b", "plain", "adamw", 2, False),
    ("moe-zero1-adamw-mb1", "mixtral-8x7b", "zero1", "adamw", 1, False),
    ("encdec-plain-adamw-mb2", "seamless-m4t-large-v2", "plain", "adamw", 2,
     False),
    ("encdec-zero1-adamw-mb2", "seamless-m4t-large-v2", "zero1", "adamw", 2,
     False),
]
IDS = [c[0] for c in CASES]
# global batch (rows, tokens) per arch: the MoE's groups hold 64 tokens
# at 2 microbatches (128 at 1), past the 16-token capacity floor
SHAPE = {"llama3-8b": (4, 16), "mixtral-8x7b": (8, 32),
         "seamless-m4t-large-v2": (4, 16)}


def _cfg(arch):
    """The reduced f32 config the cases run (the MoE's dispatch groups 2
    and capacity factor 1.25)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe_dispatch_groups=2,
            moe=dataclasses.replace(cfg.moe, capacity_factor=CF))
    return cfg


def _run(mode, optimizer, mb, int8):
    return RunConfig(optimizer=optimizer, learning_rate=LR, microbatches=mb,
                     zero1=mode == "zero1", fsdp=mode == "fsdp",
                     grad_compression="int8" if int8 else None)


def _batch(cfg, seed=0):
    """The global batch: labels masked unevenly, so the ranks' counts of
    unmasked labels differ in every microbatch."""
    rows, s = SHAPE[cfg.name]
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (rows, s)).astype(np.int32)}
    for r, k in enumerate((s - 4, 0, 3, s - 1, 5, 0, s // 2, 1)[:rows]):
        out["labels"][r, :k] = -1
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(0, 0.02, (rows, 12, cfg.d_model)) \
            .astype(np.float32)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(t):
    return t.detach().float().numpy().copy()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in optim.tree_leaves(tree))


def _steps(step, state, batch, n=2):
    ms = []
    for _ in range(n):
        state, m = step(state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


# ------------------------------------------------------------ rank bodies
def _same_on_ranks(tensors) -> bool:
    """Whether every rank holds bit-equal ``tensors``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    got = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(got, flat)
    return all(torch.equal(g.view(torch.int32), flat.view(torch.int32))
               for g in got)


def _case(rank, mesh, case, ref_params, batch):
    _, arch, mode, optimizer, mb, int8 = case
    cfg, run = _cfg(arch), _run(mode, optimizer, mb, int8)
    params = params_from_reference(ref_params, device=mesh.device)
    state = init_state(cfg, run, params, mesh=mesh)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    state, ms = _steps(step, state, shard_rows(_tensors(batch),
                                               DataShard(rank, W)))
    return {"metrics": ms,
            "params": {k: _np(v) for k, v in _flat(state["params"]).items()},
            "same": _same_on_ranks(optim.tree_leaves(state["params"])),
            "opt_bytes": _nbytes(state["opt"]),
            "acc_bytes": step.held["grad_acc_bytes"]}


def _naive_means(rank, ref_params, batch):
    """The MoE's NLL and load balance as per-rank means averaged over the
    ranks (what the reference does not compute), at the first step's
    parameters, one microbatch."""
    cfg = _cfg("mixtral-8x7b")
    params = params_from_reference(ref_params, device="cpu")
    with torch.no_grad():
        _, m = zoo.loss_fn(cfg)(params, shard_rows(_tensors(batch),
                                                   DataShard(rank, W)))
    v = torch.stack([m["nll"], m["load_balance"]]) / W
    dist.all_reduce(v)
    return {"nll": float(v[0]), "load_balance": float(v[1])}


def _checkpoint_round_trip(rank, mesh, ref_params, batch, tmp):
    """ZeRO-1 AdamW: save at step 1 (W ranks), restore into one process
    (rank 0) and save from there, restore into the W ranks and take step
    2: bit-equal to the uninterrupted step 2."""
    cfg, run = _cfg("llama3-8b"), _run("zero1", "adamw", 2, False)
    local = shard_rows(_tensors(batch), DataShard(rank, W))
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)

    def fresh():
        return init_state(cfg, run, params_from_reference(ref_params,
                                                          device="cpu"),
                          mesh=mesh)
    state, _ = step(fresh(), local)
    a, b = os.path.join(tmp, "w2"), os.path.join(tmp, "w1")
    ckpt.save(state, a, 1, group=dist.group.WORLD)
    whole = optim.tree_map(lambda t: t.detach().clone(),
                           elastic.gather_state(state))
    mu1 = optim.tree_leaves(state["opt"]["mu"])
    marks = [collective.shard_of(t) is not None for t in mu1]
    mu1 = [t.clone() for t in mu1]
    state, _ = step(state, local)
    want = optim.tree_leaves({k: state[k] for k in ("params", "opt")})
    out = {}
    if rank == 0:
        one_run = dataclasses.replace(run, zero1=False)
        one = init_state(cfg, one_run, params_from_reference(
            ref_params, device="cpu"))
        one, at = ckpt.restore(one, a)
        out["one_equal"] = at == 1 and all(
            torch.equal(x, y.detach()) for x, y in
            zip(optim.tree_leaves(one), optim.tree_leaves(whole)))
        ckpt.save(one, b, 1)
    dist.barrier()
    back, at = ckpt.restore(fresh(), b)
    out["shards_marked"] = any(marks) and marks == [
        collective.shard_of(x) is not None
        for x in optim.tree_leaves(back["opt"]["mu"])]
    back, _ = step(back, local)
    got = optim.tree_leaves({k: back[k] for k in ("params", "opt")})
    out["continues"] = at == 1 and all(torch.equal(x.detach(), y.detach())
                                       for x, y in zip(got, want))
    # elastic: the gathered state re-cut onto the ranks is the live state
    recut = elastic.reshard_state(
        {"mu": whole["opt"]["mu"]}, {"mu": _axes(cfg)}, mesh,
        dict(default_rules(), embed="data"))
    recut = optim.tree_leaves(recut)
    out["reshard"] = all(torch.equal(x, y) for x, y in zip(recut, mu1)) \
        and marks == [collective.shard_of(x) is not None for x in recut]
    return out


def _host_copies(rank, mesh, ref_params, batch, tmp):
    """How many leaves each rank copies to the host in a group's
    ``ckpt.save`` and ``AsyncCheckpointer.maybe_save`` of a ZeRO-1
    state: the writer (rank 0) copies every leaf, the others none."""
    cfg, run = _cfg("llama3-8b"), _run("zero1", "adamw", 1, False)
    state = init_state(cfg, run, params_from_reference(ref_params,
                                                       device="cpu"),
                       mesh=mesh)
    real, calls = ckpt._to_numpy, []

    def spy(leaf, copy=False):
        if isinstance(leaf, torch.Tensor):      # a copy off the tensor
            calls.append(1)
        return real(leaf, copy)
    out = {"leaves": len(ckpt._flatten(state))}
    ckpt._to_numpy = spy
    try:
        ckpt.save(state, os.path.join(tmp, "copies"), 0,
                  group=dist.group.WORLD)
        out["save"] = len(calls)
        saver = ckpt.AsyncCheckpointer(os.path.join(tmp, "copies_async"),
                                       group=dist.group.WORLD)
        saver.maybe_save(state, 1)
        saver.wait()
        out["async"] = len(calls) - out["save"]
    finally:
        ckpt._to_numpy = real
    return out


def _axes(cfg):
    from repro_torch.models.params import axes_tree
    return axes_tree(zoo.model_specs(cfg))


def _fault_loop(rank, mesh, ref_params, tmp):
    """ZeRO-1 under run_training: a failure injected on rank 1 at step 3
    (checkpoints every 2) restores both ranks; the end state equals an
    uninterrupted run's bit for bit."""
    cfg, run = _cfg("llama3-8b"), _run("zero1", "adamw", 1, False)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    batches = lambda s: shard_rows(_tensors(_batch(cfg, seed=s)),
                                   DataShard(rank, W))
    ends = []
    for fails in ((), (3,)):
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cpu"),
                           mesh=mesh)
        fc = FaultConfig(ckpt_dir=os.path.join(tmp, f"loop{len(ends)}"),
                         ckpt_every=2, inject_failures_at=fails,
                         inject_rank=1)
        state, stats = run_training(step, state, batches, 5, fc,
                                    group=dist.group.WORLD)
        ends.append((state, stats))
    (a, sa), (b, sb) = ends
    return {"restarts": (sa.restarts, sb.restarts),
            "losses": sb.losses == sa.losses[:3] + sa.losses[2:],
            "equal": all(torch.equal(x, y) for x, y in zip(
                optim.tree_leaves({k: a[k] for k in ("params", "opt")}),
                optim.tree_leaves({k: b[k] for k in ("params", "opt")}))),
            "step": int(b["step"])}


def _refusals(rank, mesh, ref_params, batch):
    """What raises: FSDP over a data axis of distinct cards in one
    process, FSDP with a model axis over ranks that would cut an SSM
    head (an ssm config of 3 heads on a line of 2: the step and the
    state), a batch that does not divide into microbatches x ranks, MoE
    groups not a multiple of the ranks, and a model axis over ranks for
    that config (ROADMAP Queue A item 11; the families' tensor
    parallelism is tests/test_torch_train_tp*.py's)."""
    out = {}
    cfg = _cfg("llama3-8b")
    params = params_from_reference(ref_params["llama3-8b"], device="cpu")
    local = shard_rows(_tensors(batch["llama3-8b"]), DataShard(rank, W))

    def raises(kind, fn):
        try:
            fn()
        except kind as e:
            return str(e)
        return None
    run = _run("fsdp", "adafactor", 1, False)
    cards = LogicalMesh(("data", "model"), (2, 1),
                        devices=("cuda:0", "cuda:1"))
    out["fsdp_cards"] = raises(NotImplementedError, lambda: build_train_step(
        cfg, run, mesh=cards))
    model = LogicalMesh(("data", "model"), (1, W), group=dist.group.WORLD,
                        device="cpu")
    moe = _cfg("mixtral-8x7b")
    mp = params_from_reference(ref_params["mixtral-8x7b"], device="cpu")
    base = get_arch("mamba2-780m").reduced()
    ssm = dataclasses.replace(base, d_model=96, ssm=dataclasses.replace(
        base.ssm, head_dim=64))              # 3 heads of 64 over d_in 192
    out["fsdp_model_state"] = raises(NotImplementedError, lambda: init_state(
        ssm, run, {}, mesh=model))
    run = _run("plain", "adamw", 4, False)
    out["batch"] = raises(ValueError, lambda: build_train_step(
        cfg, run, mesh=mesh)(init_state(cfg, run, params), local))
    one_group = dataclasses.replace(moe, moe_dispatch_groups=1)
    run = _run("plain", "adamw", 1, False)
    out["groups"] = raises(ValueError, lambda: build_train_step(
        one_group, run, mesh=mesh)(init_state(one_group, run, mp), shard_rows(
            _tensors(batch["mixtral-8x7b"]), DataShard(rank, W))))
    out["fsdp_model"] = raises(NotImplementedError, lambda: build_train_step(
        ssm, RunConfig(fsdp=True), mesh=model))
    out["model"] = raises(NotImplementedError, lambda: build_train_step(
        ssm, RunConfig(), mesh=model))
    return out


def _rank_body(rank, device, ref_params, batches, tmp):
    torch.set_num_threads(2)
    mesh = make_host_mesh(device=device)
    out = {"cases": {c[0]: _case(rank, mesh, c, ref_params[c[1]],
                                 batches[c[1]]) for c in CASES}}
    out["naive"] = _naive_means(rank, ref_params["mixtral-8x7b"],
                                batches["mixtral-8x7b"])
    out["ckpt"] = _checkpoint_round_trip(rank, mesh, ref_params["llama3-8b"],
                                         batches["llama3-8b"], tmp)
    out["fault"] = _fault_loop(rank, mesh, ref_params["llama3-8b"], tmp)
    out["copies"] = _host_copies(rank, mesh, ref_params["llama3-8b"],
                                 batches["llama3-8b"], tmp)
    out["refuse"] = _refusals(rank, mesh, ref_params, batches)
    return out


def _pod_body(rank, device, ref_params, batch):
    """Four ranks on a ("pod", "data", "model") mesh of (2, 2, 1): the
    batch over pod x data, ZeRO-1's and FSDP's chunks over data within
    each pod (replicated over pod: FSDP's gradients reduce-scatter over
    data, then all-reduce over pod)."""
    torch.set_num_threads(1)
    mesh = LogicalMesh(("pod", "data", "model"), (2, 2, 1),
                       group=dist.group.WORLD, device=device)
    out = {}
    for mode in ("plain", "zero1", "fsdp"):
        cfg, run = _cfg("llama3-8b"), _run(mode, "adamw", 2, False)
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cpu"),
                           mesh=mesh, dp_axes=("pod", "data"))
        step = build_train_step(cfg, run, total_steps=100,
                                dp_axes=("pod", "data"), mesh=mesh)
        state, ms = _steps(step, state, shard_rows(_tensors(batch),
                                                   DataShard(rank, 4)))
        whole = elastic.gather_state(state["params"])
        out[mode] = {"metrics": ms, "same": _same_on_ranks(
            optim.tree_leaves(whole)),
            "params": {k: _np(v) for k, v in _flat(whole).items()},
            "opt_bytes": _nbytes(state["opt"]),
            "param_bytes": _nbytes(state["params"])}
    return out


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def R():
    """jax and the reference's modules (imported in the parent only)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import base, registry
    from repro.models import params, zoo as rzoo
    from repro.train import step as rstep
    return SimpleNamespace(jax=jax, jnp=jnp, base=base, ARCHS=registry.ARCHS,
                           zoo=rzoo, init=params.init_params, step=rstep)


def _ref_cfg(R, arch):
    cfg = _cfg(arch)
    rcfg = dataclasses.replace(R.ARCHS[arch].reduced(), dtype="float32")
    if rcfg.moe is not None:
        rcfg = dataclasses.replace(
            rcfg, moe_dispatch_groups=cfg.moe_dispatch_groups,
            moe=dataclasses.replace(rcfg.moe, capacity_factor=CF))
    return rcfg


@pytest.fixture(scope="module")
def inputs(R):
    """Per arch the reference's initial parameters (numpy) and the global
    batch."""
    ref_params, batches = {}, {}
    for arch in SHAPE:
        rcfg = _ref_cfg(R, arch)
        rp = R.init(R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(0),
                    "float32")
        ref_params[arch] = R.jax.tree.map(np.asarray, rp)
        batches[arch] = _batch(_cfg(arch))
    return ref_params, batches


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every case on the W = 2 gloo ranks (one spawn)."""
    ref_params, batches = inputs
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_rank_body, W, (ref_params, batches, tmp),
                         backend="gloo", timeout_s=600)


@pytest.fixture(scope="module")
def pod_ranks(inputs):
    """Plain DP, ZeRO-1 and FSDP on four gloo ranks over pod x data, the
    global batch of 8 rows (one spawn)."""
    ref_params, _ = inputs
    batch = _batch(_cfg("llama3-8b"))
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    got = run_ranks(_pod_body, 4, (ref_params["llama3-8b"], batch),
                    backend="gloo", timeout_s=600)
    return batch, got


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's jitted one-device step, two steps on the global
    batch, per (arch, optimizer, microbatches) the cases need.  The
    warm-up's lr is 0 at step 0, so both steps' metrics read the initial
    parameters and the second step's update shows in the parameters: a
    third step's metrics would read Adam's first, sign-like update, where
    f32 rounding flips the sign of near-zero gradient elements (a step
    of +-lr either way) and parts the one-process port from itself
    across microbatch splits by ~1e-4."""
    ref_params, batches = inputs
    out = {}
    for _, arch, _, optimizer, mb, int8 in CASES:
        key = (arch, optimizer, mb)
        if int8 or key in out:
            continue
        rcfg = _ref_cfg(R, arch)
        rrun = R.base.RunConfig(optimizer=optimizer, learning_rate=LR,
                                microbatches=mb)
        state = R.step.init_state(rcfg, rrun, R.jax.tree.map(
            R.jnp.asarray, ref_params[arch]))
        step = R.jax.jit(R.step.build_train_step(rcfg, rrun,
                                                 total_steps=100))
        jb = {k: R.jnp.asarray(v) for k, v in batches[arch].items()}
        ms = []
        for _ in range(2):
            state, m = step(state, jb)
            ms.append({k: float(v) for k, v in m.items()})
        out[key] = (ms, _flat(R.jax.tree.map(np.asarray, state["params"])))
    return out


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's own one-process step on the global batch per case."""
    ref_params, batches = inputs
    out = {}
    for cid, arch, mode, optimizer, mb, int8 in CASES:
        cfg, run = _cfg(arch), _run(mode, optimizer, mb, int8)
        state = init_state(cfg, run, params_from_reference(ref_params[arch],
                                                           device="cpu"))
        step = build_train_step(cfg, run, total_steps=100)
        state, ms = _steps(step, state, _tensors(batches[arch]))
        out[cid] = (ms, {k: _np(v) for k, v in
                         _flat(state["params"]).items()})
    return out


# ------------------------------------------------------------------ tests
def _metrics_close(got, want, rtol):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-8,
                                       err_msg=k)


def _params_close(got, want, rel):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err, scale = np.abs(got[k] - w).max(), np.abs(w).max()
        assert err <= rel * scale, f"{k}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("cid", [c[0] for c in CASES if not c[5]])
def test_dp_step_matches_reference_on_global_batch(ranks, reference,
                                                   one_process, cid):
    """Both ranks' steps against the reference's one-device step on the
    global batch: every metric within METRIC_RTOL of the reference's,
    parameters within SCALED of their scale, the ranks' parameters
    bit-equal.  Where the port's own one-process step on these inputs is
    itself further from the reference than METRIC_RTOL (the gradient
    norm: random fan_in weights amplify f32 rounding, 5.5e-5 relative
    for llama, 1.0e-3 for encdec, 6.5e-3 for the MoE here, as
    tests/test_torch_train.py finds gradient by gradient), the
    data-parallel step may be no further from it than that step plus
    PORT_METRIC_RTOL: the ranks add no departure of their own."""
    _, arch, _, optimizer, mb, _ = next(c for c in CASES if c[0] == cid)
    want_m, want_p = reference[(arch, optimizer, mb)]
    port_m = one_process[cid][0]
    for r in ranks:
        got = r["cases"][cid]
        assert got["same"]
        for g, w, o in zip(got["metrics"], want_m, port_m):
            assert sorted(g) == sorted(w)
            for k in w:
                bar = max(METRIC_RTOL * abs(w[k]),
                          abs(o[k] - w[k]) + PORT_METRIC_RTOL * abs(w[k]))
                assert abs(g[k] - w[k]) <= bar + 1e-8, (k, g[k], w[k], o[k])
    _params_close(ranks[0]["cases"][cid]["params"], want_p, SCALED)


@pytest.mark.parametrize("cid", IDS)
def test_dp_step_matches_one_process_port(ranks, one_process, cid):
    """Against the port's one-process step on the global batch (int8
    included): metrics PORT_METRIC_RTOL, parameters PORT_PARAM_REL of
    their scale."""
    want_m, want_p = one_process[cid]
    got = ranks[0]["cases"][cid]
    _metrics_close(got["metrics"], want_m, PORT_METRIC_RTOL)
    _params_close(got["params"], want_p, PORT_PARAM_REL)


def test_moe_case_drops_tokens(inputs):
    """The MoE cases run with drops: at capacity factor 1.25 some
    expert's assignments in a dispatch group exceed its capacity."""
    from repro_torch.models import moe
    ref_params, batches = inputs
    cfg = _cfg("mixtral-8x7b")
    params = params_from_reference(ref_params["mixtral-8x7b"], device="cpu")
    seen = []
    real = moe._dispatch_one_group

    def spy(xf, logits, m, cap):
        out = real(xf, logits, m, cap)
        seen.append((xf.shape[0] * m.top_k, int(out[3].sum())))
        return out
    moe._dispatch_one_group = spy
    try:
        with torch.no_grad():
            zoo.loss_fn(cfg)(params, _tensors(batches["mixtral-8x7b"]))
    finally:
        moe._dispatch_one_group = real
    assert seen and any(kept < total for total, kept in seen), seen


def test_rank_means_differ_from_reference(ranks, reference):
    """The trap the step avoids: per-rank means of the NLL and of the
    load balance, averaged over the ranks, part from the reference's
    global ones by more than ten times the bar (so the step's tests
    bite)."""
    want = reference[("mixtral-8x7b", "adamw", 1)][0][0]
    naive = ranks[0]["naive"]
    got = ranks[0]["cases"]["moe-zero1-adamw-mb1"]["metrics"][0]
    for k in ("nll", "load_balance"):
        assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k])
        assert abs(naive[k] - want[k]) > 10 * METRIC_RTOL * abs(want[k]), \
            (k, naive[k], want[k])


@pytest.mark.parametrize("cid", [c[0] for c in CASES if c[2] == "zero1"])
def test_zero1_bytes_equal_abstract_state(ranks, cid):
    """Each rank's optimizer state and f32 accumulators hold exactly the
    shard bytes ``abstract_state`` and the gradient shardings describe
    on a (2, 1) mesh; plain DP's would be the whole."""
    _, arch, mode, optimizer, mb, int8 = next(c for c in CASES
                                              if c[0] == cid)
    cfg, run = _cfg(arch), _run(mode, optimizer, mb, int8)
    mesh = LogicalMesh(("data", "model"), (W, 1))
    specs = zoo.model_specs(cfg)
    state = abstract_state(cfg, run, specs, mesh, default_rules())

    def shard_bytes(t, sharding):
        n = int(np.prod(sharding.shard_shape(tuple(t.shape)))) \
            if t.dim() else 1
        return n * t.element_size()
    opt = sum(shard_bytes(t, t.sharding)
              for t in optim.tree_leaves(state["opt"]))
    acc = sum(int(np.prod(s.shard_shape(tuple(p.shape)))) * 4
              for p, s in zip(optim.tree_leaves(state["params"]),
                              optim.tree_leaves(zero1_grad_shardings(
                                  cfg, run, mesh))))
    for r in ranks:
        got = r["cases"][cid]
        assert (got["opt_bytes"], got["acc_bytes"]) == (opt, acc)
    whole = sum(p.numel() for p in optim.tree_leaves(state["params"])) * 4
    assert acc < whole


@pytest.mark.parametrize("what", ["one_equal", "shards_marked", "continues",
                                  "reshard"])
def test_zero1_checkpoint_moves_between_ranks_and_one_process(ranks, what):
    """A W = 2 ZeRO-1 checkpoint holds the one-device layout: it restores
    into one process (equal to the gathered state), that process's
    checkpoint restores into the ranks' chunks, and step 2 from it is
    bit-equal to the uninterrupted step 2; the elastic gather + reshard
    gives back the live chunks."""
    for r in ranks:
        if what in r["ckpt"]:
            assert r["ckpt"][what] is True, (what, r["ckpt"])


@pytest.mark.parametrize("how", ["save", "async"])
def test_checkpoint_host_copy_on_the_writer_alone(ranks, how):
    """Under a group every rank gathers the chunks, but only the writer
    (rank 0) copies the state to the host: at full width a copy on each
    rank would hold W whole states in host memory."""
    assert ranks[0]["copies"][how] == ranks[0]["copies"]["leaves"] > 0
    assert all(r["copies"][how] == 0 for r in ranks[1:])


def test_fault_loop_restores_every_rank(ranks):
    """One rank's injected failure: both ranks restart once from the
    step-2 checkpoint and end bit-equal to the uninterrupted run, the
    replayed step's loss repeated."""
    for r in ranks:
        f = r["fault"]
        assert f["restarts"] == (0, 1) and f["step"] == 5
        assert f["losses"] and f["equal"]


@pytest.mark.parametrize("what,match", [
    ("fsdp_cards", "FSDP over a data axis 'data' of several distinct "
                   "devices in one process"),
    ("fsdp_model_state", "would cut a head"),
    ("batch", "does not divide"), ("groups", "multiple of the ranks"),
    ("fsdp_model", "tensor parallelism"), ("model", "item 11")])
def test_refusals(ranks, what, match):
    for r in ranks:
        assert r["refuse"][what] is not None and match in r["refuse"][what], \
            r["refuse"][what]


@pytest.mark.parametrize("mode", ["plain", "zero1", "fsdp"])
def test_pod_by_data_ranks_match_one_process(pod_ranks, inputs, mode):
    """Over a (2, 2, 1) pod x data x model mesh of four ranks: every
    rank's (gathered) parameters bit-equal, metrics and parameters at
    the port bars of the one-process step on the global batch, and
    under ZeRO-1 and FSDP the moments (FSDP: the parameters too)
    chunked over data only (abstract_state's shard bytes on that
    mesh)."""
    batch, got = pod_ranks
    ref_params, _ = inputs
    cfg, run = _cfg("llama3-8b"), _run(mode, "adamw", 2, False)
    state = init_state(cfg, run, params_from_reference(
        ref_params["llama3-8b"], device="cpu"))
    state, want = _steps(build_train_step(cfg, run, total_steps=100), state,
                         _tensors(batch))
    for r in got:
        assert r[mode]["same"]
        _metrics_close(r[mode]["metrics"], want, PORT_METRIC_RTOL)
    _params_close(got[0][mode]["params"], {k: _np(v) for k, v in
                                           _flat(state["params"]).items()},
                  PORT_PARAM_REL)
    mesh = LogicalMesh(("pod", "data", "model"), (2, 2, 1))
    ab = abstract_state(cfg, run, zoo.model_specs(cfg), mesh,
                        default_rules(fsdp=run.fsdp))

    def shard_bytes(tree):
        return sum(int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
                   * t.element_size() for t in optim.tree_leaves(tree))
    assert all(r[mode]["opt_bytes"] == shard_bytes(ab["opt"]) for r in got)
    assert all(r[mode]["param_bytes"] == shard_bytes(ab["params"])
               for r in got)


def test_microbatch_rows_are_the_reference_layout():
    """Rank r's rows of microbatch i: i*B/mb + r*B/(mb*W) onward, and a
    batch that does not divide is refused."""
    assert microbatch_rows(16, 4, DataShard(1, 4)) == [
        (1, 2), (5, 6), (9, 10), (13, 14)]
    assert microbatch_rows(8, 2, DataShard(0, 2)) == [(0, 2), (4, 6)]
    with pytest.raises(ValueError, match="does not divide"):
        microbatch_rows(6, 2, DataShard(0, 2))


def test_launcher_reports_a_rank_failure():
    """A rank that raises: run_ranks raises with its traceback."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        run_ranks(_fail_on_rank_1, 2, backend="gloo", timeout_s=120)


def _fail_on_rank_1(rank, device):
    if rank == 1:
        raise ValueError("boom")
    return rank


# ---------------------------------------------------------------- on cards
NCCL_LR = 1e-3


def _nccl_body(rank, device, ref_params, batch):
    mesh = make_host_mesh()
    out = {}
    for mode in ("plain", "zero1"):
        cfg = _cfg("llama3-8b")
        run = dataclasses.replace(_run(mode, "adamw", 2, False),
                                  learning_rate=NCCL_LR)
        params = params_from_reference(ref_params, device=device)
        state = init_state(cfg, run, params, mesh=mesh)
        step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
        local = {k: v.to(device) for k, v in shard_rows(
            _tensors(batch), DataShard(rank, W)).items()}
        state, ms = _steps(step, state, local)
        out[mode] = (ms, {k: _np(v.cpu()) for k, v in
                          _flat(state["params"]).items()})
    return out


@pytest.mark.gpu
def test_nccl_ranks_match_one_card_step():
    """Two NCCL ranks, one card each, plain DP and ZeRO-1 on the reduced
    f32 llama: against the one-card step on the global batch at
    PORT_METRIC_RTOL x 10 and PORT_PARAM_REL.  The matrices are halved:
    at the fan_in weights the card's f32 GEMMs at another row count move
    the gradient norm by ~3e-4 (the one-card step on the card parts from
    the same step on the CPU by 4.2e-4), past any 1e-5 comparison; at
    half the scale both agree within ~1e-7 (PERF.md).  The learning
    rate is chip_smoke's 1e-3 for the same reason: Adam's first update,
    lr g / (|g| + eps), turns f32 noise in gradient elements near eps
    into up to ~2% of lr, which at LR reaches 2.1e-5 of the embedding's
    scale (measured), past PORT_PARAM_REL."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < W:
        pytest.skip(f"needs {W} CUDA devices: NCCL takes one card a rank")
    from repro_torch.models.params import init_params
    cfg = _cfg("llama3-8b")
    params = optim.tree_map(
        lambda p: p * 0.5 if p.dim() >= 2 else p,
        init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(0),
                    "float32", device="cpu"))
    ref_params = optim.tree_map(lambda p: p.detach().numpy(), params)
    batch = _batch(cfg)
    got = run_ranks(_nccl_body, W, (ref_params, batch), timeout_s=600)
    for mode in ("plain", "zero1"):
        run = dataclasses.replace(_run(mode, "adamw", 2, False),
                                  learning_rate=NCCL_LR)
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cuda"))
        step = build_train_step(cfg, run, total_steps=100)
        state, want = _steps(step, state, {k: v.cuda() for k, v in
                                           _tensors(batch).items()})
        for r in got:
            _metrics_close(r[mode][0], want, 10 * PORT_METRIC_RTOL)
            _params_close(r[mode][1], {k: _np(v.cpu()) for k, v in
                                       _flat(state["params"]).items()},
                          PORT_PARAM_REL)
