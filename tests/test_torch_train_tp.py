"""Tensor parallelism (the ``model`` axis over ranks) over W = 4 gloo
ranks on the CPU, composed with plain DP, ZeRO-1 and FSDP.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on the four ranks, on two meshes of them
(``make_host_mesh(model_parallel=...)``): (data 1, model 4), where
reduced llama3-8b's 4 q heads give one a rank and the divisibility
guard leaves its 2 kv heads whole (each rank runs the kv head of its q
head, and that weight's gradient is summed over the model line), and
(data 2, model 2), where every rank holds half the heads, the MLP's
columns and the vocabulary, and plain DP, ZeRO-1 and FSDP run over
the data line.  Each rank passes its data coordinate's ``DataShard``
block of the global batch.  The parent holds the results to:

* the reference's one-device jitted step on the concatenated global
  batch, at ``test_train_step_matches_reference``'s bars (metrics 1e-5
  relative, every parameter within ``SCALED`` of its scale), or no
  further from it than the port's own one-process step plus the port
  bars, as tests/test_torch_train_fsdp.py holds FSDP: AdamW at 1 and 2
  microbatches (remat none and full) on both meshes, Adafactor on
  (1, 4) and on (2, 2) under ZeRO-1 and FSDP, 8-bit Adam on FSDP + TP;
* the port's own one-process step on the same inputs (int8 included)
  at ``PORT_METRIC_RTOL`` and ``PORT_PARAM_REL``.  Where a step rounds
  to int8 (8-bit Adam's moments, the int8 gradient) a last-bit
  difference of the ranks' f32 sums can flip a code; there fewer than
  ``FLIP_FRAC`` of the elements may part further, and under 8-bit Adam
  each of them sits on a moment code that differs from the one-process
  step's.

The matrices are scaled by ``SCALE`` (as the NCCL tests of
tests/test_torch_train_dp.py and test_torch_train_fsdp.py scale them):
at the fan_in weights the reduced model's activations run ~100 and its
grad norm ~424, and f32 rounding alone puts the one-process gradient
0.75% from the float64 one, so the TP step's reordered f32 sums part
from it by ~0.2%.  ``test_tp_gradients_equal_one_process_in_float64``
holds the TP gradients at the fan_in weights in float64, where they
meet the one-process float64 gradients within ``F64_REL`` (an uneven kv
grouping, one kv head a q head, included).

Besides: each rank's parameter, optimizer-state and accumulator bytes
equal ``abstract_state``'s shard bytes on the mesh; a 2 x 2 FSDP + TP
checkpoint restores into one process and back and continues bit-equal,
and the elastic reshard gives back the live chunks; the fault loop
restores every rank; whole weights under TP raise (the other families
are tests/test_torch_train_tp_families.py's and
test_torch_train_tp_ssm.py's), and a model axis over several cards in
one process stays refused.  ``jax`` and
``repro`` are imported in the parent's fixtures only.  The ``gpu`` test
runs two NCCL ranks on ``model`` where there are two cards.
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

W = 4
MESHES = {"tp4": (1, 4), "dp2tp2": (2, 2)}      # (data, model)
ARCH = "llama3-8b"
SCALE = 0.5
SCALED = 2e-3                   # as tests/test_torch_train.py
METRIC_RTOL = 1e-5              # against the reference
PORT_METRIC_RTOL = 1e-6         # against the port's one-process step
PORT_PARAM_REL = 2e-5           # of each parameter's scale, ditto
FLIP_FRAC = 1e-4                # of the elements, where codes round
F64_REL = 1e-5                  # float64 gradients, of each leaf's scale
LR = 5e-3
ROWS, SEQ = 4, 16               # the global batch
# (id, mesh, mode, optimizer, microbatches, int8, remat)
CASES = [
    ("tp4-plain-adamw-mb1", "tp4", "plain", "adamw", 1, False, "none"),
    ("tp4-plain-adamw-mb2", "tp4", "plain", "adamw", 2, False, "full"),
    ("tp4-plain-adafactor-mb2", "tp4", "plain", "adafactor", 2, False,
     "full"),
    ("dp2tp2-plain-adamw-mb1", "dp2tp2", "plain", "adamw", 1, False, "none"),
    ("dp2tp2-plain-adamw-mb2", "dp2tp2", "plain", "adamw", 2, False, "full"),
    ("dp2tp2-zero1-adamw-mb1", "dp2tp2", "zero1", "adamw", 1, False, "none"),
    ("dp2tp2-zero1-adamw-mb2", "dp2tp2", "zero1", "adamw", 2, False, "full"),
    ("dp2tp2-zero1-adafactor-mb2", "dp2tp2", "zero1", "adafactor", 2, False,
     "full"),
    ("dp2tp2-fsdp-adamw-mb1", "dp2tp2", "fsdp", "adamw", 1, False, "none"),
    ("dp2tp2-fsdp-adamw-mb2", "dp2tp2", "fsdp", "adamw", 2, False, "full"),
    ("dp2tp2-fsdp-adafactor-mb2", "dp2tp2", "fsdp", "adafactor", 2, False,
     "full"),
    ("dp2tp2-fsdp-adamw8bit-mb2", "dp2tp2", "fsdp", "adamw8bit", 2, False,
     "full"),
    ("dp2tp2-fsdp-adamw-mb2-int8", "dp2tp2", "fsdp", "adamw", 2, True,
     "full"),
]
IDS = [c[0] for c in CASES]
# float64 gradient checks at the fan_in weights: (id, mesh, config)
F64_CASES = [("tp4", "tp4", "llama"), ("dp2tp2", "dp2tp2", "llama"),
             ("uneven-kv", "dp2tp2", "uneven")]


def _cfg(remat="none", dtype="float32", uneven=False):
    """Reduced llama3-8b (4 q heads, 2 kv heads, d_ff 256, vocab 512) at
    ``remat``; ``uneven``: 12 q heads of 16 over 3 kv heads, which a
    model line of 2 leaves whole and which no even GQA grouping covers
    on a rank (its 6 q heads use kv heads 0, 0, 0, 0, 1, 1)."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype,
                              remat=remat)
    if uneven:
        cfg = dataclasses.replace(cfg, n_heads=12, n_kv_heads=3, head_dim=16)
    return cfg


def _run(mode, optimizer, mb, int8):
    return RunConfig(optimizer=optimizer, learning_rate=LR, microbatches=mb,
                     zero1=mode == "zero1", fsdp=mode == "fsdp",
                     grad_compression="int8" if int8 else None)


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


def _batch(seed=0):
    """The global batch: labels masked unevenly, so the data ranks'
    counts of unmasked labels differ in every microbatch."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 512, (ROWS, SEQ)).astype(np.int32),
           "labels": rng.integers(0, 512, (ROWS, SEQ)).astype(np.int32)}
    for r, k in enumerate((SEQ - 4, 0, 3, SEQ - 1)):
        out["labels"][r, :k] = -1
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


def _scaled(tree):
    """Every matrix (a leaf of 2 or more dims) times SCALE."""
    return optim.tree_map(lambda a: a * SCALE if a.ndim >= 2 else a, tree)


def _steps(step, state, batch, n=2):
    ms = []
    for _ in range(n):
        state, m = step(state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _codes(state) -> dict:
    """8-bit Adam's moment codes by parameter path, (2, elements): mu's
    and nu's, in the whole leaf's row-major order (the blocks are whole
    on every rank)."""
    q = _flat(state["opt"]["q"])
    return {k[:-len("/mu_q")]: np.stack([q[k].numpy().reshape(-1),
                                         q[k[:-4] + "nu_q"].numpy()
                                         .reshape(-1)])
            for k in q if k.endswith("/mu_q")}


# ------------------------------------------------------------ rank bodies
def _same_on_ranks(tensors) -> bool:
    """Whether every rank holds bit-equal ``tensors``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    got = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(got, flat)
    return all(torch.equal(g.view(torch.int32), flat.view(torch.int32))
               for g in got)


def _local(mesh, batch):
    """This rank's block of ``batch``: its data coordinate's."""
    return shard_rows(_tensors(batch), DataShard(mesh.coords()["data"],
                                                 mesh.shape["data"]))


def _train(mesh, mode, optimizer, mb, int8, remat, ref_params, batch):
    """Two steps of one case on this rank: (state, metrics, step)."""
    cfg, run = _cfg(remat), _run(mode, optimizer, mb, int8)
    state = init_state(cfg, run, params_from_reference(ref_params,
                                                       device=mesh.device),
                       mesh=mesh)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    state, ms = _steps(step, state, _local(mesh, batch))
    return state, ms, step


def _cases(meshes, ref_params, batch):
    out = {}
    for cid, mesh, mode, optimizer, mb, int8, remat in CASES:
        state, ms, step = _train(meshes[mesh], mode, optimizer, mb, int8,
                                 remat, ref_params, batch)
        whole = elastic.gather_state(state["params"])
        out[cid] = {"metrics": ms,
                    "params": {k: _np(v) for k, v in _flat(whole).items()},
                    "same": _same_on_ranks(optim.tree_leaves(whole)),
                    "param_bytes": _nbytes(state["params"]),
                    "held_param_bytes": step.held["param_bytes"],
                    "opt_bytes": _nbytes(state["opt"]),
                    "acc_bytes": step.held["grad_acc_bytes"],
                    "codes": _codes(state) if optimizer == "adamw8bit"
                    else None}
    return out


def _f64_grads(meshes, params64):
    """Per F64_CASES entry the loss's float64 gradient at the fan_in
    weights on this rank's chunks, summed over the data line and
    gathered over the model line (the whole gradient)."""
    out = {}
    batch = _batch()
    for cid, name, which in F64_CASES:
        mesh = meshes[name]
        cfg = _cfg(dtype="float64", uneven=which == "uneven")
        chunks = shard_params(cfg, RunConfig(), params64[which], mesh)
        leaves = optim.tree_leaves(chunks)
        for p in leaves:
            p.requires_grad_(True)
        dgroup, dsize, _ = mesh.line(("data",))
        mgroup, msize, mindex = mesh.line(("model",))
        dp = collective.DataParallel(dgroup, dsize, model=collective.ModelLine(
            mgroup, msize, mindex))
        with collective.data_parallel(dp):
            loss, _ = zoo.loss_fn(cfg)(chunks, _local(mesh, batch))
            grads = torch.autograd.grad(loss, leaves)
        whole = []
        for p, g in zip(leaves, grads):
            g = g.detach().clone()
            dist.all_reduce(g, group=dgroup)
            m = collective.model_of(p)
            whole.append((g if m is None else collective.all_gather(g, m))
                         .numpy().copy())
        out[cid] = (float(loss.detach()), whole)
    return out


def _checkpoint_round_trip(rank, mesh, ref_params, batch, tmp):
    """FSDP + TP AdamW on (2, 2): save at step 1 (four ranks), restore
    into one process (rank 0) and save from there, restore into the
    ranks' chunks and take step 2: bit-equal to the uninterrupted step
    2; the elastic reshard of the gathered parameters gives back the
    live chunks, marked alike."""
    cfg, run = _cfg("full"), _run("fsdp", "adamw", 2, False)
    local = _local(mesh, batch)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)

    def fresh():
        return init_state(cfg, run, params_from_reference(ref_params,
                                                          device="cpu"),
                          mesh=mesh)

    def marks(tree):
        return [(collective.shard_of(t) is not None,
                 collective.model_of(t) is not None)
                for t in optim.tree_leaves(tree)]
    state, _ = step(fresh(), local)
    a, b = os.path.join(tmp, "tp_w4"), os.path.join(tmp, "tp_w1")
    ckpt.save(state, a, 1, group=dist.group.WORLD)
    whole = optim.tree_map(lambda t: t.detach().clone(),
                           elastic.gather_state(state))
    live = [t.detach().clone() for t in optim.tree_leaves(state["params"])]
    live_marks = marks(state)
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
    out["marked"] = any(m for m, _ in live_marks) and any(
        m for _, m in live_marks) and marks(back) == live_marks
    back, _ = step(back, local)
    got = optim.tree_leaves({k: back[k] for k in ("params", "opt")})
    out["continues"] = at == 1 and all(torch.equal(x.detach(), y.detach())
                                       for x, y in zip(got, want))
    recut = elastic.reshard_state(whole["params"],
                                  axes_tree(zoo.model_specs(cfg)), mesh,
                                  default_rules(fsdp=True))
    out["reshard"] = all(torch.equal(x, y) for x, y in zip(
        optim.tree_leaves(recut), live)) and marks(recut) == marks(
            state["params"])
    return out


def _fault_loop(rank, mesh, ref_params, tmp):
    """FSDP + TP under run_training on (2, 2): a failure injected on rank
    1 at step 3 (checkpoints every 2) restores every rank; the end state
    equals an uninterrupted run's bit for bit."""
    cfg, run = _cfg("full"), _run("fsdp", "adamw", 1, False)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    ends = []
    for fails in ((), (3,)):
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cpu"),
                           mesh=mesh)
        fc = FaultConfig(ckpt_dir=os.path.join(tmp, f"floop{len(ends)}"),
                         ckpt_every=2, inject_failures_at=fails,
                         inject_rank=1)
        state, stats = run_training(
            step, state, lambda s: _local(mesh, _batch(seed=s)), 5, fc,
            group=dist.group.WORLD)
        ends.append((state, stats))
    (a, sa), (b, sb) = ends
    return {"restarts": (sa.restarts, sb.restarts),
            "losses": sb.losses == sa.losses[:3] + sa.losses[2:],
            "equal": all(torch.equal(x, y) for x, y in zip(
                optim.tree_leaves({k: a[k] for k in ("params", "opt")}),
                optim.tree_leaves({k: b[k] for k in ("params", "opt")}))),
            "step": int(b["step"])}


def _refusals(mesh, ref_params, batch):
    """What raises under TP: a step given whole weights."""
    def raises(kind, fn):
        try:
            fn()
        except kind as e:
            return str(e)
        return None
    cfg, run = _cfg(), _run("plain", "adamw", 1, False)
    whole = init_state(cfg, run, params_from_reference(ref_params,
                                                       device="cpu"))
    return {"whole": raises(ValueError, lambda: build_train_step(
        cfg, run, mesh=mesh)(whole, _local(mesh, batch)))}


def _rank_body(rank, device, ref_params, params64, batch, tmp):
    torch.set_num_threads(1)
    meshes = {k: make_host_mesh(model_parallel=m, device=device)
              for k, (_, m) in MESHES.items()}
    return {"coords": {k: m.coords() for k, m in meshes.items()},
            "cases": _cases(meshes, ref_params, batch),
            "f64": _f64_grads(meshes, params64),
            "ckpt": _checkpoint_round_trip(rank, meshes["dp2tp2"],
                                           ref_params, batch, tmp),
            "fault": _fault_loop(rank, meshes["dp2tp2"], ref_params, tmp),
            "refuse": _refusals(meshes["tp4"], ref_params, batch)}


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


def _ref_cfg(R):
    return dataclasses.replace(R.ARCHS[ARCH].reduced(), dtype="float32")


@pytest.fixture(scope="module")
def inputs(R):
    """The reference's initial parameters (numpy, matrices x SCALE), the
    float64 fan_in parameters of the gradient checks (llama's and the
    uneven grouping's, drawn by the port) and the global batch."""
    rp = R.init(R.zoo.model_specs(_ref_cfg(R)), R.jax.random.PRNGKey(0),
                "float32")
    params64 = {}
    for which in ("llama", "uneven"):
        cfg = _cfg(uneven=which == "uneven")
        params64[which] = optim.tree_map(
            lambda p: p.double(), init_params(
                zoo.model_specs(cfg), torch.Generator().manual_seed(1),
                "float32", device="cpu"))
    return _scaled(R.jax.tree.map(np.asarray, rp)), params64, _batch()


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank body on the W = 4 gloo ranks (one spawn)."""
    ref_params, params64, batch = inputs
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_rank_body, W, (ref_params, params64, batch, tmp),
                         backend="gloo", timeout_s=600)


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's jitted one-device step, two steps on the global
    batch, per (optimizer, microbatches) the cases need (its remat none:
    remat changes no value, tests/test_torch_train.py).  The warm-up's
    lr is 0 at step 0, so both steps' metrics read the initial
    parameters and the second step's update shows in the parameters."""
    ref_params, _, batch = inputs
    out = {}
    rcfg = _ref_cfg(R)
    for _, _, _, optimizer, mb, int8, _ in CASES:
        key = (optimizer, mb)
        if int8 or key in out:
            continue
        rrun = R.base.RunConfig(optimizer=optimizer, learning_rate=LR,
                                microbatches=mb)
        state = R.step.init_state(rcfg, rrun, R.jax.tree.map(
            R.jnp.asarray, ref_params))
        step = R.jax.jit(R.step.build_train_step(rcfg, rrun,
                                                 total_steps=100))
        jb = {k: R.jnp.asarray(v) for k, v in batch.items()}
        ms = []
        for _ in range(2):
            state, m = step(state, jb)
            ms.append({k: float(v) for k, v in m.items()})
        out[key] = (ms, _flat(R.jax.tree.map(np.asarray, state["params"])))
    return out


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's own one-process step on the global batch per case."""
    ref_params, _, batch = inputs
    out = {}
    for cid, _, mode, optimizer, mb, int8, remat in CASES:
        cfg, run = _cfg(remat), _run(mode, optimizer, mb, int8)
        state = init_state(cfg, run, params_from_reference(ref_params,
                                                           device="cpu"))
        step = build_train_step(cfg, run, total_steps=100)
        state, ms = _steps(step, state, _tensors(batch))
        out[cid] = (ms, {k: _np(v) for k, v in
                         _flat(state["params"]).items()},
                    _codes(state) if optimizer == "adamw8bit" else None)
    return out


# ------------------------------------------------------------------ tests
def test_rank_layout_is_row_major(ranks):
    """``make_host_mesh(model_parallel=m)`` puts rank r at data r // m,
    model r % m: the model lines are consecutive ranks."""
    for r, got in enumerate(ranks):
        for name, (_, m) in MESHES.items():
            assert got["coords"][name] == {"data": r // m, "model": r % m}


@pytest.mark.parametrize("cid", [c[0] for c in CASES if not c[5]])
def test_tp_step_matches_reference_on_global_batch(ranks, reference,
                                                   one_process, cid):
    """Every rank's step against the reference's one-device step on the
    global batch: every metric within METRIC_RTOL of the reference's, or
    no further from it than the port's own one-process step plus
    PORT_METRIC_RTOL; the gathered parameters bit-equal on the ranks and
    within SCALED of their scale, or no further from the reference than
    the one-process step plus PORT_PARAM_REL of it."""
    _, _, _, optimizer, mb, _, _ = _case(cid)
    want_m, want_p = reference[(optimizer, mb)]
    port_m, port_p, _ = one_process[cid]
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
def test_tp_step_matches_one_process_port(ranks, one_process, cid):
    """Against the port's one-process step on the global batch: metrics
    within PORT_METRIC_RTOL, parameters within PORT_PARAM_REL of their
    scale.  Where the step rounds to int8 (8-bit Adam's moments, the
    int8 gradient), fewer than FLIP_FRAC of a leaf's elements may part
    further: a wrong uniform, scale or block would move most of them;
    under 8-bit Adam each one sits on a mu or nu code that differs from
    the one-process step's."""
    _, _, _, optimizer, _, int8, _ = _case(cid)
    want_m, want_p, want_codes = one_process[cid]
    got = ranks[0]["cases"][cid]
    for g, w in zip(got["metrics"], want_m):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=PORT_METRIC_RTOL,
                                       atol=1e-8, err_msg=k)
    discrete = int8 or optimizer == "adamw8bit"
    assert sorted(got["params"]) == sorted(want_p)
    for k, w in want_p.items():
        far = np.abs(got["params"][k] - w) > PORT_PARAM_REL * np.abs(w).max()
        if not discrete:
            assert not far.any(), k
            continue
        assert far.mean() < FLIP_FRAC, (k, int(far.sum()))
        if want_codes is not None:
            flipped = (got["codes"][k] != want_codes[k]).any(axis=0)
            assert flipped[np.flatnonzero(far)].all(), k


@pytest.mark.parametrize("cid", [c[0] for c in F64_CASES])
def test_tp_gradients_equal_one_process_in_float64(ranks, inputs, cid):
    """At the fan_in weights, in float64: the loss on every rank and the
    gradient of every leaf (summed over the data line, gathered over the
    model line) against the one-process float64 step's, within F64_REL of
    the leaf's scale, the loss within PORT_METRIC_RTOL (the model's own
    f32 casts, in its norms and head, leave ~1e-6 and ~1e-7)."""
    _, params64, batch = inputs
    which = next(c[2] for c in F64_CASES if c[0] == cid)
    cfg = _cfg(dtype="float64", uneven=which == "uneven")
    params = optim.tree_map(lambda p: p.clone(), params64[which])
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg)(params, _tensors(batch))
    want = torch.autograd.grad(loss, leaves)
    for r in ranks:
        got_loss, got = r["f64"][cid]
        assert abs(got_loss - float(loss.detach())) <= \
            PORT_METRIC_RTOL * abs(float(loss.detach()))
        for g, w in zip(got, want):
            w = w.numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= F64_REL * np.abs(w).max()


@pytest.mark.parametrize("cid", IDS)
def test_tp_bytes_equal_abstract_state(ranks, cid):
    """Each rank holds exactly the shard bytes ``abstract_state``
    describes on the case's (data, model) mesh under
    ``default_rules(fsdp=...)``: the parameters (the model chunks; under
    FSDP their data chunks), the optimizer state (ZeRO-1 and FSDP: its
    data chunks of the model chunks; 8-bit Adam's blocks whole) and the
    f32 accumulators (ZeRO-1's gradient shardings; plain DP: the model
    chunks whole on the data line)."""
    _, mesh, mode, optimizer, mb, int8, remat = _case(cid)
    cfg, run = _cfg(remat), _run(mode, optimizer, mb, int8)
    desc = LogicalMesh(("data", "model"), MESHES[mesh])
    state = abstract_state(cfg, run, zoo.model_specs(cfg), desc,
                           default_rules(fsdp=run.fsdp))

    def shards(pairs):
        return [int(np.prod(s.shard_shape(tuple(t.shape))))
                for t, s in pairs]
    params = optim.tree_leaves(state["params"])
    acc = 4 * sum(shards(zip(params, optim.tree_leaves(zero1_grad_shardings(
        cfg, run, desc))) if mode != "plain" else
        [(t, t.sharding) for t in params]))

    def shard_bytes(tree):
        return sum(n * t.element_size() if t.dim() else t.element_size()
                   for n, t in zip(shards((t, t.sharding) for t in
                                          optim.tree_leaves(tree)),
                                   optim.tree_leaves(tree)))
    want = (shard_bytes(state["params"]), shard_bytes(state["opt"]), acc)
    for r in ranks:
        got = r["cases"][cid]
        assert (got["param_bytes"], got["opt_bytes"], got["acc_bytes"]) \
            == want
        assert got["held_param_bytes"] == got["param_bytes"]
    whole = sum(p.numel() * p.element_size() for p in params)
    assert want[0] < whole


@pytest.mark.parametrize("what", ["one_equal", "marked", "continues",
                                  "reshard"])
def test_tp_checkpoint_moves_between_ranks_and_one_process(ranks, what):
    """A 2 x 2 FSDP + TP checkpoint holds the one-device layout: it
    restores into one process (equal to the gathered state), that
    process's checkpoint restores into the ranks' chunks (marked with
    their data and model splits) and step 2 from it is bit-equal to the
    uninterrupted step 2; the elastic reshard of the gathered parameters
    gives back the live chunks."""
    for r in ranks:
        if what in r["ckpt"]:
            assert r["ckpt"][what] is True, (what, r["ckpt"])


def test_tp_fault_loop_restores_every_rank(ranks):
    """One rank's injected failure: all four ranks restart once from the
    step-2 checkpoint and end bit-equal to the uninterrupted run."""
    for r in ranks:
        f = r["fault"]
        assert f["restarts"] == (0, 1) and f["step"] == 5
        assert f["losses"] and f["equal"]


def test_tp_refuses_whole_weights(ranks):
    """A TP step given whole weights raises: no rank may quietly run
    them unsplit."""
    for r in ranks:
        got = r["refuse"]["whole"]
        assert got is not None and "not this rank's chunk" in got, got


def test_model_axis_over_cards_in_one_process_stays_refused():
    """A model axis over several distinct devices in one process (GSPMD
    in the reference) is refused: the port runs one process a card."""
    two = LogicalMesh(("data", "model"), (1, 2),
                      (torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(NotImplementedError, match="model axis.*item 8"):
        build_train_step(_cfg(), RunConfig(), mesh=two)


# ---------------------------------------------------------------- on cards
NCCL_W = 2


def _nccl_body(rank, device, params, batch):
    """Two NCCL ranks on (data 1, model 2): two steps of AdamW in two
    microbatches (remat full), the gathered parameters; rank 0 also the
    one-card step on its card."""
    cfg, run = _cfg("full"), _run("plain", "adamw", 2, False)
    out = {}
    if rank == 0:
        state = init_state(cfg, run, params_from_reference(params,
                                                           device=device))
        step = build_train_step(cfg, run, total_steps=100)
        state, ms = _steps(step, state, {k: v.to(device) for k, v in
                                         _tensors(batch).items()})
        out["one"] = (ms, [t.detach().cpu() for t in
                           optim.tree_leaves(state["params"])])
    mesh = make_host_mesh(model_parallel=NCCL_W)
    state = init_state(cfg, run, params_from_reference(params,
                                                       device=device),
                       mesh=mesh)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    state, ms = _steps(step, state, {k: v.to(device) for k, v in
                                     _local(mesh, batch).items()})
    out["tp"] = (ms, [t.detach().cpu() for t in optim.tree_leaves(
        elastic.gather_state(state["params"]))])
    return out


@pytest.mark.gpu
def test_nccl_model_ranks_match_one_card_step():
    """Two NCCL ranks, one card each, on the model axis (reduced f32
    llama, matrices x SCALE, remat full): every metric within
    METRIC_RTOL and every gathered parameter within PORT_PARAM_REL of
    its scale of the one-card step on the same global batch."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < NCCL_W:
        pytest.skip(f"needs {NCCL_W} CUDA devices: NCCL takes one card a "
                    "rank")
    cfg = _cfg()
    params = _scaled(optim.tree_map(
        lambda p: p.numpy(), init_params(
            zoo.model_specs(cfg), torch.Generator().manual_seed(0),
            "float32", device="cpu")))
    got = run_ranks(_nccl_body, NCCL_W, (params, _batch()), timeout_s=600)
    want_m, want_p = got[0]["one"]
    for r in got:
        ms, ps = r["tp"]
        for g, w in zip(ms, want_m):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                           atol=1e-8, err_msg=k)
        for a, b in zip(ps, want_p):
            assert float((a - b).abs().max()) <= \
                PORT_PARAM_REL * float(b.abs().max())
