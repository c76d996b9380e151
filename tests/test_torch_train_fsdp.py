"""FSDP and Adafactor on shards over W = 2 gloo ranks on the CPU.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on both ranks; each rank passes its ``DataShard`` block of
the global batch.  Under FSDP (``RunConfig(fsdp=True)``) each rank
holds its chunk of every parameter's ``embed`` dim, the model gathers
a layer's chunks where the layer runs, and each gather's backward pass
reduce-scatters the gradient in f32 into the rank's accumulator chunk.
The parent holds the results to:

* the reference's one-device jitted step on the concatenated global
  batch, at ``test_train_step_matches_reference``'s bars (metrics 1e-5
  relative, every parameter within ``SCALED`` of its scale), or no
  further from it than the port's own one-process step plus the port
  bars (as tests/test_torch_train_dp.py holds the grad norm): FSDP x
  {adamw, adafactor, adamw8bit} on reduced llama3-8b at 1 and 2
  microbatches (remat none and full), FSDP + Adafactor on a reduced MoE
  with drops (kimi's pairing), FSDP on encdec, on the hybrid (its
  shared block and ``shared_proj``) and on a tied-embedding config
  (mamba2), ZeRO-1 + Adafactor;
* the port's own one-process step on the same inputs (int8 included)
  at ``PORT_METRIC_RTOL`` and ``PORT_PARAM_REL``;
* ZeRO-1 on the same ranks, batch and initial state, bit for bit:
  losses, grad norms, every parameter chunk and every optimizer-state
  chunk (the two steps reduce the same f32 numbers in the same order).

Besides: each rank's parameter, optimizer-state and accumulator bytes
equal ``abstract_state``'s and the gradient shardings' shard bytes
(Adafactor's factors included); a W = 2 FSDP checkpoint restores into
one process and back and continues bit-equal, the elastic gather and
reshard give back the live chunks; the fault loop under the group
restores both ranks; ``shard_params`` draws a lazy tree leaf by leaf;
a gather outside a step returns the chunk's gradient; a step given
whole weights under FSDP raises.  ``jax`` and ``repro``
are imported in the parent's fixtures only.  The 2 x 2 pod x data FSDP
case is in ``tests/test_torch_train_dp.py``'s four-rank spawn.  The
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
from repro_torch.data.pipeline import DataShard, shard_rows
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import zoo
from repro_torch.models.params import axes_tree, init_params
from repro_torch.runtime import elastic
from repro_torch.runtime.fault import FaultConfig, run_training
from repro_torch.sharding import collective
from repro_torch.sharding.logical import LogicalMesh, default_rules
from repro_torch.train import optim
from repro_torch.train.step import (abstract_state, build_train_step,
                                    init_state, shard_params,
                                    zero1_grad_shardings)

W = 2
SCALED = 2e-3                   # as tests/test_torch_train.py
METRIC_RTOL = 1e-5              # against the reference
PORT_METRIC_RTOL = 1e-6         # against the port's one-process step
PORT_PARAM_REL = 2e-5           # of each parameter's scale, ditto
LR = 5e-3
CF = 1.25                       # the MoE capacity factor (drops)
OPTS = ("adamw", "adafactor", "adamw8bit")
# (id, arch, mode, optimizer, microbatches, int8, remat)
CASES = [
    *[(f"llama-fsdp-{o}-mb{mb}", "llama3-8b", "fsdp", o, mb, False,
       "full" if mb == 2 else "none") for o in OPTS for mb in (1, 2)],
    ("llama-fsdp-adamw-mb2-int8", "llama3-8b", "fsdp", "adamw", 2, True,
     "full"),
    ("moe-fsdp-adafactor-mb2", "mixtral-8x7b", "fsdp", "adafactor", 2,
     False, "full"),
    ("encdec-fsdp-adamw-mb2", "seamless-m4t-large-v2", "fsdp", "adamw", 2,
     False, "full"),
    ("hybrid-fsdp-adamw-mb1", "zamba2-2.7b", "fsdp", "adamw", 1, False,
     "full"),
    ("tied-fsdp-adamw-mb2", "mamba2-780m", "fsdp", "adamw", 2, False,
     "selective"),
    ("llama-zero1-adafactor-mb1", "llama3-8b", "zero1", "adafactor", 1,
     False, "none"),
    ("llama-zero1-adafactor-mb2", "llama3-8b", "zero1", "adafactor", 2,
     False, "full"),
    ("moe-zero1-adafactor-mb2", "mixtral-8x7b", "zero1", "adafactor", 2,
     False, "full"),
]
IDS = [c[0] for c in CASES]
FSDP_IDS = [c[0] for c in CASES if c[2] == "fsdp"]
# global batch (rows, tokens) per arch: the MoE's groups hold 64 tokens
# at 2 microbatches, past the 16-token capacity floor
SHAPE = {"llama3-8b": (4, 16), "mixtral-8x7b": (8, 32),
         "seamless-m4t-large-v2": (4, 16), "zamba2-2.7b": (4, 16),
         "mamba2-780m": (4, 16)}


def _cfg(arch, remat="none"):
    """The reduced f32 config (the MoE's dispatch groups 2 and capacity
    factor 1.25), at ``remat``."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              remat=remat)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe_dispatch_groups=2,
            moe=dataclasses.replace(cfg.moe, capacity_factor=CF))
    return cfg


def _run(mode, optimizer, mb, int8):
    return RunConfig(optimizer=optimizer, learning_rate=LR, microbatches=mb,
                     zero1=mode == "zero1", fsdp=mode == "fsdp",
                     grad_compression="int8" if int8 else None)


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


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


def _train(mesh, rank, arch, mode, optimizer, mb, int8, remat, ref_params,
           batch):
    """Two steps of one mode on this rank: (state, metrics, step)."""
    cfg, run = _cfg(arch, remat), _run(mode, optimizer, mb, int8)
    state = init_state(cfg, run, params_from_reference(ref_params,
                                                       device=mesh.device),
                       mesh=mesh)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    state, ms = _steps(step, state, shard_rows(_tensors(batch),
                                               DataShard(rank, W)))
    return state, ms, step


def _versus(fsdp, zero1) -> dict:
    """FSDP's state against ZeRO-1's on this rank: each parameter chunk
    against its chunk of ZeRO-1's whole parameter, each optimizer-state
    leaf against ZeRO-1's (the same chunks), bit for bit; with the
    largest difference where they part."""
    worst = 0.0
    pairs = []
    for p, w in zip(optim.tree_leaves(fsdp["params"]),
                    optim.tree_leaves(zero1["params"])):
        sh = collective.shard_of(p)
        pairs.append((p, w if sh is None else sh.of(w)))
    pairs += list(zip(optim.tree_leaves(fsdp["opt"]),
                      optim.tree_leaves(zero1["opt"])))
    equal = True
    for a, b in pairs:
        a, b = a.detach(), b.detach()
        if a.shape != b.shape:
            return {"equal": False, "worst": float("inf")}
        if not torch.equal(a, b):
            equal = False
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    return {"equal": equal, "worst": worst}


def _cases(rank, mesh, ref_params, batches):
    out, zero1 = {}, {}
    for cid, arch, mode, optimizer, mb, int8, remat in CASES:
        state, ms, step = _train(mesh, rank, arch, mode, optimizer, mb, int8,
                                 remat, ref_params[arch], batches[arch])
        whole = elastic.gather_state(state["params"])
        got = {"metrics": ms,
               "params": {k: _np(v) for k, v in _flat(whole).items()},
               "same": _same_on_ranks(optim.tree_leaves(whole)),
               "param_bytes": _nbytes(state["params"]),
               "held_param_bytes": step.held["param_bytes"],
               "opt_bytes": _nbytes(state["opt"]),
               "acc_bytes": step.held["grad_acc_bytes"]}
        if mode == "fsdp":
            key = (arch, optimizer, mb, int8, remat)
            if key not in zero1:
                zero1[key] = _train(mesh, rank, arch, "zero1", optimizer, mb,
                                    int8, remat, ref_params[arch],
                                    batches[arch])[:2]
            z_state, z_ms = zero1[key]
            got["zero1_metrics"] = z_ms
            got["versus"] = _versus(state, z_state)
        out[cid] = got
    return out


def _checkpoint_round_trip(rank, mesh, ref_params, batch, tmp):
    """FSDP AdamW: save at step 1 (W ranks), restore into one process
    (rank 0) and save from there, restore into the W ranks' chunks and
    take step 2: bit-equal to the uninterrupted step 2."""
    cfg, run = _cfg("llama3-8b", "full"), _run("fsdp", "adamw", 2, False)
    local = shard_rows(_tensors(batch), DataShard(rank, W))
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)

    def fresh():
        return init_state(cfg, run, params_from_reference(ref_params,
                                                          device="cpu"),
                          mesh=mesh)
    state, _ = step(fresh(), local)
    a, b = os.path.join(tmp, "fsdp_w2"), os.path.join(tmp, "fsdp_w1")
    ckpt.save(state, a, 1, group=dist.group.WORLD)
    whole = optim.tree_map(lambda t: t.detach().clone(),
                           elastic.gather_state(state))
    live = [t.detach().clone() for t in optim.tree_leaves(state["params"])]
    marks = [collective.shard_of(t) is not None
             for t in optim.tree_leaves(state["params"])]
    state, _ = step(state, local)
    want = optim.tree_leaves({k: state[k] for k in ("params", "opt")})
    out = {}
    if rank == 0:
        one_run = dataclasses.replace(run, fsdp=False)
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
        for x in optim.tree_leaves(back["params"])]
    back, _ = step(back, local)
    got = optim.tree_leaves({k: back[k] for k in ("params", "opt")})
    out["continues"] = at == 1 and all(torch.equal(x.detach(), y.detach())
                                       for x, y in zip(got, want))
    # elastic: the gathered parameters re-cut onto the ranks are the live
    # chunks, marked alike
    recut = optim.tree_leaves(elastic.reshard_state(
        whole["params"], axes_tree(zoo.model_specs(cfg)), mesh,
        default_rules(fsdp=True)))
    out["reshard"] = all(torch.equal(x, y) for x, y in zip(recut, live)) \
        and marks == [collective.shard_of(x) is not None for x in recut]
    return out


def _fault_loop(rank, mesh, ref_params, tmp):
    """FSDP under run_training: a failure injected on rank 1 at step 3
    (checkpoints every 2) restores both ranks; the end state equals an
    uninterrupted run's bit for bit."""
    cfg, run = _cfg("llama3-8b", "full"), _run("fsdp", "adamw", 1, False)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    batches = lambda s: shard_rows(_tensors(_batch(cfg, seed=s)),
                                   DataShard(rank, W))
    ends = []
    for fails in ((), (3,)):
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cpu"),
                           mesh=mesh)
        fc = FaultConfig(ckpt_dir=os.path.join(tmp, f"floop{len(ends)}"),
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


def _lazy_draw(rank, mesh):
    """``shard_params`` of a tree of callables (each draws its leaf with
    ``init_params``): called once each in the specs' order, the chunks
    equal to those of the whole tree drawn at once."""
    cfg, run = _cfg("llama3-8b"), _run("fsdp", "adamw", 1, False)
    specs = zoo.model_specs(cfg)
    whole = shard_params(cfg, run, init_params(
        specs, torch.Generator().manual_seed(3), "float32", device="cpu"),
        mesh)
    gen, calls = torch.Generator().manual_seed(3), []

    def lazy(tree, path=()):
        if isinstance(tree, dict):
            return {k: lazy(v, path + (k,)) for k, v in tree.items()}

        def draw():
            calls.append(path)
            return init_params({"x": tree}, gen, "float32", device="cpu")["x"]
        return draw
    got = shard_params(cfg, run, lazy(specs), mesh)
    order = list(_flat(specs))
    return {"order": ["/".join(p) for p in calls] == order,
            "equal": all(torch.equal(x, y) for x, y in zip(
                optim.tree_leaves(got), optim.tree_leaves(whole))),
            "marked": [collective.shard_of(x) is not None
                       for x in optim.tree_leaves(got)]
            == [collective.shard_of(x) is not None
                for x in optim.tree_leaves(whole)]}


def _refusals(rank, mesh, ref_params, batch):
    """What raises under FSDP: a step given whole weights (no rank may
    quietly keep them), and gradient shardings of its own."""
    cfg, run = _cfg("llama3-8b"), _run("fsdp", "adamw", 1, False)
    state = init_state(cfg, run, params_from_reference(ref_params,
                                                       device="cpu"))
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    out = {}
    try:
        step(state, shard_rows(_tensors(batch), DataShard(rank, W)))
    except ValueError as e:
        out["whole"] = str(e)
    try:
        build_train_step(cfg, run, mesh=mesh,
                         grad_shardings=zero1_grad_shardings(cfg, run, mesh))
    except ValueError as e:
        out["grad_shardings"] = str(e)
    return out


def _no_accumulator(rank, mesh, ref_params, batch):
    """Outside a step (no accumulator) a gathered chunk's forward runs
    and its backward raises: the error's message, or None."""
    cfg, run = _cfg("llama3-8b"), _run("fsdp", "adamw", 1, False)
    local = shard_rows(_tensors(batch), DataShard(rank, W))
    chunks = shard_params(cfg, run, params_from_reference(ref_params,
                                                          device="cpu"), mesh)
    leaves = optim.tree_leaves(chunks)
    for p in leaves:
        p.requires_grad_(True)
    loss = zoo.loss_fn(cfg)(chunks, local)[0]
    try:
        torch.autograd.grad(loss, leaves)
    except RuntimeError as e:
        return str(e)
    return None


def _rank_body(rank, device, ref_params, batches, tmp):
    torch.set_num_threads(2)
    mesh = make_host_mesh(device=device)
    llama = ref_params["llama3-8b"]
    return {"cases": _cases(rank, mesh, ref_params, batches),
            "ckpt": _checkpoint_round_trip(rank, mesh, llama,
                                           batches["llama3-8b"], tmp),
            "fault": _fault_loop(rank, mesh, llama, tmp),
            "lazy": _lazy_draw(rank, mesh),
            "refuse": _refusals(rank, mesh, llama, batches["llama3-8b"]),
            "no_acc": _no_accumulator(rank, mesh, llama,
                                      batches["llama3-8b"])}


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
def reference(R, inputs):
    """The reference's jitted one-device step, two steps on the global
    batch, per (arch, optimizer, microbatches) the cases need (its remat
    none: remat changes no value, tests/test_torch_train.py).  The
    warm-up's lr is 0 at step 0, so both steps' metrics read the initial
    parameters and the second step's update shows in the parameters."""
    ref_params, batches = inputs
    out = {}
    for _, arch, _, optimizer, mb, int8, _ in CASES:
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
    for cid, arch, mode, optimizer, mb, int8, remat in CASES:
        cfg, run = _cfg(arch, remat), _run(mode, optimizer, mb, int8)
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
def test_sharded_step_matches_reference_on_global_batch(ranks, reference,
                                                        one_process, cid):
    """Both ranks' steps against the reference's one-device step on the
    global batch: every metric within METRIC_RTOL of the reference's, or
    no further from it than the port's own one-process step plus
    PORT_METRIC_RTOL (the gradient norm at random fan_in weights, as
    tests/test_torch_train_dp.py); the gathered parameters bit-equal on
    the ranks and within SCALED of their scale, or no further from the
    reference than the one-process step plus PORT_PARAM_REL of it (the
    hybrid's ``A_log``, zeros before Adam's first, sign-like update: the
    one-process port moves it 5e-5 and parts from the reference there
    by ~1% of that, where f32 rounding flips near-zero gradients)."""
    _, arch, _, optimizer, mb, _, _ = _case(cid)
    want_m, want_p = reference[(arch, optimizer, mb)]
    port_m, port_p = one_process[cid]
    for r in ranks:
        got = r["cases"][cid]
        assert got["same"]
        for g, w, o in zip(got["metrics"], want_m, port_m):
            assert sorted(g) == sorted(w)
            for k in w:
                bar = max(METRIC_RTOL * abs(w[k]),
                          abs(o[k] - w[k]) + PORT_METRIC_RTOL * abs(w[k]))
                assert abs(g[k] - w[k]) <= bar + 1e-8, (k, g[k], w[k], o[k])
    got_p = ranks[0]["cases"][cid]["params"]
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        scale = np.abs(w).max()
        bar = max(SCALED * scale, np.abs(port_p[k] - w).max()
                  + PORT_PARAM_REL * scale)
        assert np.abs(got_p[k] - w).max() <= bar, k


@pytest.mark.parametrize("cid", IDS)
def test_sharded_step_matches_one_process_port(ranks, one_process, cid):
    """Against the port's one-process step on the global batch (int8
    included): metrics PORT_METRIC_RTOL, parameters PORT_PARAM_REL of
    their scale."""
    want_m, want_p = one_process[cid]
    got = ranks[0]["cases"][cid]
    _metrics_close(got["metrics"], want_m, PORT_METRIC_RTOL)
    _params_close(got["params"], want_p, PORT_PARAM_REL)


@pytest.mark.parametrize("cid", FSDP_IDS)
def test_fsdp_equals_zero1_on_the_same_ranks(ranks, cid):
    """FSDP against ZeRO-1 on the same ranks, batch and initial state:
    every step's metrics, each parameter chunk and each optimizer-state
    chunk bit-equal.  Both reduce the same bf16-or-f32 gradients in the
    same f32 sums a chunk (FSDP a layer at a time inside the backward
    pass, ZeRO-1 a whole leaf after it), so nothing may part them."""
    for r in ranks:
        got = r["cases"][cid]
        assert got["metrics"] == got["zero1_metrics"]
        assert got["versus"]["equal"], got["versus"]


@pytest.mark.parametrize("cid", IDS)
def test_sharded_bytes_equal_abstract_state(ranks, cid):
    """Each rank holds exactly the shard bytes ``abstract_state`` and the
    gradient shardings describe on a (2, 1) mesh: the parameters (FSDP:
    ``default_rules(fsdp=True)``'s chunks; ZeRO-1: whole), the optimizer
    state (Adafactor's factors, a chunk or whole by their own axes) and
    the f32 accumulators."""
    _, arch, mode, optimizer, mb, int8, remat = _case(cid)
    cfg, run = _cfg(arch, remat), _run(mode, optimizer, mb, int8)
    mesh = LogicalMesh(("data", "model"), (W, 1))
    specs = zoo.model_specs(cfg)
    state = abstract_state(cfg, run, specs, mesh,
                           default_rules(fsdp=run.fsdp))

    def shard_bytes(tree):
        return sum(int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
                   * t.element_size() if t.dim() else t.element_size()
                   for t in optim.tree_leaves(tree))
    acc = sum(int(np.prod(s.shard_shape(tuple(p.shape)))) * 4
              for p, s in zip(optim.tree_leaves(state["params"]),
                              optim.tree_leaves(zero1_grad_shardings(
                                  cfg, run, mesh))))
    want = (shard_bytes(state["params"]), shard_bytes(state["opt"]), acc)
    for r in ranks:
        got = r["cases"][cid]
        assert (got["param_bytes"], got["opt_bytes"], got["acc_bytes"]) \
            == want
        assert got["held_param_bytes"] == got["param_bytes"]
    whole = sum(p.numel() * p.element_size()
                for p in optim.tree_leaves(state["params"]))
    assert (want[0] < whole) == (mode == "fsdp")


@pytest.mark.parametrize("what", ["one_equal", "shards_marked", "continues",
                                  "reshard"])
def test_fsdp_checkpoint_moves_between_ranks_and_one_process(ranks, what):
    """A W = 2 FSDP checkpoint holds the one-device layout: it restores
    into one process (equal to the gathered state), that process's
    checkpoint restores into the ranks' chunks, and step 2 from it is
    bit-equal to the uninterrupted step 2; the elastic reshard of the
    gathered parameters gives back the live chunks."""
    for r in ranks:
        if what in r["ckpt"]:
            assert r["ckpt"][what] is True, (what, r["ckpt"])


def test_fsdp_fault_loop_restores_every_rank(ranks):
    """One rank's injected failure: both ranks restart once from the
    step-2 checkpoint and end bit-equal to the uninterrupted run."""
    for r in ranks:
        f = r["fault"]
        assert f["restarts"] == (0, 1) and f["step"] == 5
        assert f["losses"] and f["equal"]


@pytest.mark.parametrize("what", ["order", "equal", "marked"])
def test_shard_params_draws_leaf_by_leaf(ranks, what):
    """``shard_params`` over callables calls each in the specs' order and
    gives the chunks the whole tree gives, marked alike."""
    assert all(r["lazy"][what] for r in ranks)


@pytest.mark.parametrize("what,match", [
    ("whole", "not this rank's chunk"), ("grad_shardings", "pass no")])
def test_fsdp_refusals(ranks, what, match):
    """A step given whole weights under FSDP raises, and so does FSDP
    with gradient shardings of its own."""
    for r in ranks:
        got = r["refuse"].get(what)
        assert got is not None and match in got, got


def test_gather_outside_a_step_refuses_the_backward(ranks):
    """Outside a step ``collective.gather``'s forward runs and its
    backward raises: a chunk's gradient has no f32 accumulator there."""
    for r in ranks:
        assert r["no_acc"] is not None and "outside a training step" in \
            r["no_acc"], r["no_acc"]


# ---------------------------------------------------------------- on cards
NCCL_LR = 1e-3


def _nccl_body(rank, device, params, batch):
    mesh = make_host_mesh()
    out = {}
    for mode in ("zero1", "fsdp"):
        cfg = _cfg("llama3-8b", "full")
        run = dataclasses.replace(_run(mode, "adamw", 2, False),
                                  learning_rate=NCCL_LR)
        state = init_state(cfg, run, params_from_reference(params,
                                                           device=device),
                           mesh=mesh)
        step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
        local = {k: v.to(device) for k, v in shard_rows(
            _tensors(batch), DataShard(rank, W)).items()}
        state, ms = _steps(step, state, local)
        out[mode] = (ms, [t.detach().cpu() for t in optim.tree_leaves(
            elastic.gather_state(state["params"]))])
    return out


@pytest.mark.gpu
def test_nccl_fsdp_ranks_match_zero1():
    """Two NCCL ranks, one card each, FSDP and ZeRO-1 on the reduced f32
    llama (remat full, matrices halved as in
    tests/test_torch_train_dp.py's NCCL test): every metric and gathered
    parameter of FSDP bit-equal to ZeRO-1's on the same ranks."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < W:
        pytest.skip(f"needs {W} CUDA devices: NCCL takes one card a rank")
    cfg = _cfg("llama3-8b")
    params = optim.tree_map(
        lambda p: p * 0.5 if p.dim() >= 2 else p,
        init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(0),
                    "float32", device="cpu"))
    host = optim.tree_map(lambda p: p.detach().numpy(), params)
    got = run_ranks(_nccl_body, W, (host, _batch(cfg)), timeout_s=600)
    for r in got:
        assert r["fsdp"][0] == r["zero1"][0]
        assert all(torch.equal(a, b) for a, b in zip(r["fsdp"][1],
                                                     r["zero1"][1]))
