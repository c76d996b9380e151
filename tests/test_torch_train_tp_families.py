"""Tensor parallelism (the ``model`` axis over ranks) for the moe, vlm
and encdec families over W = 4 gloo ranks on the CPU, composed with
plain DP, ZeRO-1 and FSDP.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on the four ranks, on two meshes of them
(``make_host_mesh(model_parallel=...)``): (data 1, model 4) and (data 2,
model 2).  The configurations, each reduced and in f32:

* ``mixtral``: 4 experts, split over the line (one or two a rank; the
  router by its expert columns, gathered whole for the top-k, the
  gates and the aux terms);
* ``mixtral-emlp``: 3 experts, a count that divides neither line, so
  each expert's ``expert_mlp`` dim splits instead (mixtral's 8 experts
  on the production line of 16) and the router stays whole;
* ``kimi``: 4 experts split, plus its shared expert split by ``mlp``;
* ``llava``: its 8-row prefix ahead of the vocabulary-split embedding;
* ``seamless``: the encoder, the decoder and its cross-attention
  against the memory, at a vocabulary of 510 (seamless's 256,206
  divides by 2 but not by 4: the vocabulary splits on (2, 2) and stays
  whole on (1, 4)).

The MoE configurations run at capacity factor 1.25 in 2 dispatch
groups, so tokens drop.  Each rank passes its data coordinate's
``DataShard`` block of the global batch.  The parent holds the results
to:

* the reference's one-device jitted step on the concatenated global
  batch, at ``test_train_step_matches_reference``'s bars (metrics 1e-5
  relative, every parameter within ``SCALED`` of its scale), or no
  further from it than the port's own one-process step plus the port
  bars, as tests/test_torch_train_tp.py holds the dense family: AdamW
  at 1 and 2 microbatches, and on (2, 2) ZeRO-1, FSDP and Adafactor;
* the port's own one-process step at ``PORT_METRIC_RTOL`` and
  ``PORT_PARAM_REL``, AdamW's first moment too.  AdamW's second-step
  update is ``lr * sign(g)`` wherever ``|g|`` is far above its eps, so
  an element whose one-process gradient is itself f32 rounding noise
  (within ``NOISE_REL`` of the leaf's largest) may take the other sign
  on the ranks: fewer than ``FLIP_FRAC`` of a leaf's elements may part
  further, each of them such an element;
* in float64, the one-process gradients within ``F64_REL`` of each
  leaf's scale: the router and the experts under both splits (the aux
  terms counted once, the gates' gradient summed over the line), the
  encoder and the cross-attention through the memory's gradient, the
  embedding with the prefix present.  The MoE computes its router and
  its combine in f32 inside a float64 model (as the reference does), and
  at the fan_in weights f32's own rounding moves the reduced MoE's
  gradients by ~1e-4 of their scale; with the matrices x ``SCALE`` by
  under 1e-6, so the check draws the fan_in weights and scales them.

Besides: each rank's parameter, optimizer-state and accumulator bytes
equal ``abstract_state``'s shard bytes on the mesh, and a 2 x 2 FSDP +
TP checkpoint of the MoE restores into one process and back and
continues bit-equal.  The matrices are scaled by ``SCALE``, as
tests/test_torch_train_tp.py scales them.  ``jax`` and ``repro`` are
imported in the parent's fixtures only.  The ``gpu`` test runs two NCCL
ranks on ``model`` where there are two cards.
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
from repro_torch.models.params import init_params
from repro_torch.runtime import elastic
from repro_torch.sharding import collective
from repro_torch.sharding.logical import LogicalMesh, default_rules
from repro_torch.train import optim
from repro_torch.train.step import (abstract_state, build_train_step,
                                    init_state, shard_params,
                                    zero1_grad_shardings)

W = 4
MESHES = {"tp4": (1, 4), "dp2tp2": (2, 2)}      # (data, model)
SCALE = 0.5
SCALED = 2e-3                   # as tests/test_torch_train.py
METRIC_RTOL = 1e-5              # against the reference
PORT_METRIC_RTOL = 1e-6         # against the port's one-process step
PORT_PARAM_REL = 2e-5           # of each parameter's scale, ditto
F64_REL = 1e-5                  # float64 gradients, of each leaf's scale
FLIP_FRAC = 1e-4                # of a leaf's elements, where signs flip
NOISE_REL = 1e-5                # of a leaf's largest first moment
LR = 5e-3
CF = 1.25                       # the MoE capacity factor (drops)
# config -> (arch, its changes to the reduced config)
CONFIGS = {"mixtral": ("mixtral-8x7b", {}),
           "mixtral-emlp": ("mixtral-8x7b", {"n_experts": 3}),
           "kimi": ("kimi-k2-1t-a32b", {}),
           "llava": ("llava-next-34b", {}),
           "seamless": ("seamless-m4t-large-v2", {"vocab": 510})}
# the global batch (rows, tokens): the MoE's dispatch groups hold 64
# tokens at 2 microbatches, past the 16-token capacity floor
SHAPE = {"mixtral": (8, 32), "mixtral-emlp": (8, 32), "kimi": (8, 32),
         "llava": (4, 16), "seamless": (4, 16)}
# (id, config, mesh, mode, optimizer, microbatches, remat)
CASES = [
    ("mixtral-tp4-plain-adamw-mb1", "mixtral", "tp4", "plain", "adamw", 1,
     "none"),
    ("mixtral-dp2tp2-zero1-adamw-mb1", "mixtral", "dp2tp2", "zero1",
     "adamw", 1, "full"),
    ("mixtral-emlp-tp4-plain-adamw-mb2", "mixtral-emlp", "tp4", "plain",
     "adamw", 2, "full"),
    ("mixtral-emlp-dp2tp2-fsdp-adamw-mb2", "mixtral-emlp", "dp2tp2",
     "fsdp", "adamw", 2, "full"),
    ("kimi-tp4-plain-adafactor-mb2", "kimi", "tp4", "plain", "adafactor",
     2, "selective"),
    ("kimi-dp2tp2-fsdp-adafactor-mb2", "kimi", "dp2tp2", "fsdp",
     "adafactor", 2, "full"),
    ("llava-tp4-plain-adamw-mb1", "llava", "tp4", "plain", "adamw", 1,
     "none"),
    ("llava-dp2tp2-fsdp-adamw-mb1", "llava", "dp2tp2", "fsdp", "adamw", 1,
     "full"),
    ("seamless-tp4-plain-adamw-mb2", "seamless", "tp4", "plain", "adamw", 2,
     "full"),
    ("seamless-dp2tp2-zero1-adamw-mb2", "seamless", "dp2tp2", "zero1",
     "adamw", 2, "none"),
]
IDS = [c[0] for c in CASES]
# float64 gradient checks at the fan_in weights: (id, mesh, config)
F64_CASES = [("mixtral-tp4", "tp4", "mixtral"),
             ("mixtral-dp2tp2", "dp2tp2", "mixtral"),
             ("mixtral-emlp-tp4", "tp4", "mixtral-emlp"),
             ("kimi-dp2tp2", "dp2tp2", "kimi"),
             ("llava-tp4", "tp4", "llava"),
             ("seamless-tp4", "tp4", "seamless"),
             ("seamless-dp2tp2", "dp2tp2", "seamless")]


def _reduced(base, key, dtype="float32", remat="none"):
    """``key``'s reduced config from the reduced ``base`` (the port's or
    the reference's), in ``dtype`` at ``remat``."""
    changes = dict(CONFIGS[key][1])
    cfg = dataclasses.replace(base, dtype=dtype, remat=remat,
                              vocab=changes.pop("vocab", base.vocab))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=2,
                                  moe=dataclasses.replace(
                                      cfg.moe, capacity_factor=CF,
                                      **changes))
    return cfg


def _cfg(key, remat="none", dtype="float32"):
    return _reduced(get_arch(CONFIGS[key][0]).reduced(), key, dtype, remat)


def _run(mode, optimizer, mb):
    return RunConfig(optimizer=optimizer, learning_rate=LR, microbatches=mb,
                     zero1=mode == "zero1", fsdp=mode == "fsdp")


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


def _batch(key, seed=0):
    """The global batch of ``key``'s config: labels masked unevenly, so
    the data ranks' counts of unmasked labels differ in every
    microbatch; a vlm's prefix, an encdec's source frames."""
    cfg = _cfg(key)
    rows, s = SHAPE[key]
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (rows, s)).astype(np.int32)}
    for r, k in enumerate((s - 4, 0, 3, s - 1, 5, 0, s // 2, 1)[:rows]):
        out["labels"][r, :k] = -1
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (rows, cfg.n_prefix_embeds, cfg.d_model)) \
            .astype(np.float32)
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
    return t.detach().float().cpu().numpy().copy()


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


def _cases(meshes, ref_params, batches):
    out = {}
    for cid, key, mesh, mode, optimizer, mb, remat in CASES:
        mesh = meshes[mesh]
        cfg, run = _cfg(key, remat), _run(mode, optimizer, mb)
        state = init_state(cfg, run, params_from_reference(
            ref_params[key], device="cpu"), mesh=mesh)
        step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
        state, ms = _steps(step, state, _local(mesh, batches[key]))
        whole = elastic.gather_state(state["params"])
        out[cid] = {"metrics": ms,
                    "params": {k: _np(v) for k, v in _flat(whole).items()},
                    "same": _same_on_ranks(optim.tree_leaves(whole)),
                    "param_bytes": _nbytes(state["params"]),
                    "held_param_bytes": step.held["param_bytes"],
                    "opt_bytes": _nbytes(state["opt"]),
                    "acc_bytes": step.held["grad_acc_bytes"],
                    "mu": _moment(state)}
    return out


def _moment(state):
    """AdamW's first moment by parameter path, whole (None for another
    optimizer)."""
    if "mu" not in state["opt"]:
        return None
    return {k: _np(v) for k, v in _flat(elastic.gather_state(
        state["opt"]["mu"])).items()}


def _f64_grads(meshes, params64, batches):
    """Per F64_CASES entry the loss's float64 gradient at the fan_in
    weights on this rank's chunks, summed over the data line and
    gathered over the model line (the whole gradient)."""
    out = {}
    for cid, name, key in F64_CASES:
        mesh = meshes[name]
        cfg = _cfg(key, dtype="float64")
        chunks = shard_params(cfg, RunConfig(), params64[key], mesh)
        leaves = optim.tree_leaves(chunks)
        for p in leaves:
            p.requires_grad_(True)
        dgroup, dsize, _ = mesh.line(("data",))
        mgroup, msize, mindex = mesh.line(("model",))
        dp = collective.DataParallel(dgroup, dsize, model=collective.ModelLine(
            mgroup, msize, mindex))
        local = {k: v.double() if v.is_floating_point() else v
                 for k, v in _local(mesh, batches[key]).items()}
        with collective.data_parallel(dp):
            loss, _ = zoo.loss_fn(cfg)(chunks, local)
            grads = torch.autograd.grad(loss, leaves)
        whole = []
        for p, g in zip(leaves, grads):
            g = g.detach().clone()
            dist.all_reduce(g, group=dgroup)
            m = collective.model_of(p)
            whole.append((g if m is None else collective.all_gather(g, m))
                         .numpy().copy())
        out[cid] = (float(loss.detach()), whole,
                    [m is not None for m in map(collective.model_of, leaves)])
    return out


def _checkpoint_round_trip(rank, mesh, ref_params, batch, tmp):
    """FSDP + TP AdamW on (2, 2), the MoE: save at step 1 (four ranks),
    restore into one process (rank 0) and save from there, restore into
    the ranks' chunks and take step 2: bit-equal to the uninterrupted
    step 2."""
    cfg, run = _cfg("mixtral", "full"), _run("fsdp", "adamw", 2)
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
    a, b = os.path.join(tmp, "moe_w4"), os.path.join(tmp, "moe_w1")
    ckpt.save(state, a, 1, group=dist.group.WORLD)
    whole = optim.tree_map(lambda t: t.detach().clone(),
                           elastic.gather_state(state))
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
    return out


def _rank_body(rank, device, ref_params, params64, batches, tmp):
    torch.set_num_threads(1)
    meshes = {k: make_host_mesh(model_parallel=m, device=device)
              for k, (_, m) in MESHES.items()}
    return {"cases": _cases(meshes, ref_params, batches),
            "f64": _f64_grads(meshes, params64, batches),
            "ckpt": _checkpoint_round_trip(rank, meshes["dp2tp2"],
                                           ref_params["mixtral"],
                                           batches["mixtral"], tmp)}


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def R():
    """jax and the reference's modules (imported in the parent only)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import base, registry
    from repro.models import zoo as rzoo
    from repro.train import step as rstep
    return SimpleNamespace(jax=jax, jnp=jnp, base=base, ARCHS=registry.ARCHS,
                           zoo=rzoo, step=rstep)


def _ref_cfg(R, key):
    return _reduced(R.ARCHS[CONFIGS[key][0]].reduced(), key)


@pytest.fixture(scope="module")
def inputs(R):
    """Per config the initial parameters of both steps (numpy: the port's
    fan_in draw, at the reference's leaf paths, matrices x SCALE), the
    float64 parameters of the gradient checks (another draw, matrices x
    SCALE) and the global batch."""
    def draw(key, seed):
        return _scaled(optim.tree_map(lambda p: p.numpy(), init_params(
            zoo.model_specs(_cfg(key)), torch.Generator().manual_seed(seed),
            "float32", device="cpu")))
    ref, params64, batches = {}, {}, {}
    for key in CONFIGS:
        ref[key] = draw(key, 0)
        assert sorted(_flat(R.zoo.model_specs(_ref_cfg(R, key)))) == \
            sorted(_flat(ref[key]))
        params64[key] = optim.tree_map(lambda p: torch.from_numpy(p).double(),
                                       draw(key, 1))
        batches[key] = _batch(key)
    return ref, params64, batches


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank body on the W = 4 gloo ranks (one spawn)."""
    ref_params, params64, batches = inputs
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_rank_body, W, (ref_params, params64, batches, tmp),
                         backend="gloo", timeout_s=600)


@pytest.fixture(scope="module")
def reference(R, inputs):
    """The reference's jitted one-device step, two steps on the global
    batch, per case (its remat none: remat changes no value,
    tests/test_torch_train.py).  The warm-up's lr is 0 at step 0, so
    both steps' metrics read the initial parameters and the second
    step's update shows in the parameters."""
    ref_params, _, batches = inputs
    out = {}
    for cid, key, _, _, optimizer, mb, _ in CASES:
        if (key, optimizer, mb) in out:
            out[cid] = out[key, optimizer, mb]
            continue
        rcfg = _ref_cfg(R, key)
        rrun = R.base.RunConfig(optimizer=optimizer, learning_rate=LR,
                                microbatches=mb)
        state = R.step.init_state(rcfg, rrun, R.jax.tree.map(
            R.jnp.asarray, ref_params[key]))
        step = R.jax.jit(R.step.build_train_step(rcfg, rrun,
                                                 total_steps=100))
        jb = {k: R.jnp.asarray(v) for k, v in batches[key].items()}
        ms = []
        for _ in range(2):
            state, m = step(state, jb)
            ms.append({k: float(v) for k, v in m.items()})
        out[cid] = out[key, optimizer, mb] = (
            ms, _flat(R.jax.tree.map(np.asarray, state["params"])))
    return out


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's own one-process step on the global batch per case."""
    ref_params, _, batches = inputs
    out = {}
    for cid, key, _, mode, optimizer, mb, remat in CASES:
        cfg, run = _cfg(key, remat), _run(mode, optimizer, mb)
        state = init_state(cfg, run, params_from_reference(ref_params[key],
                                                           device="cpu"))
        step = build_train_step(cfg, run, total_steps=100)
        state, ms = _steps(step, state, _tensors(batches[key]))
        out[cid] = (ms, {k: _np(v) for k, v in
                         _flat(state["params"]).items()}, _moment(state))
    return out


# ------------------------------------------------------------------ tests
def test_configs_take_both_moe_splits():
    """The guard splits reduced mixtral's and kimi's 4 experts over both
    lines (router by column) and ``mixtral-emlp``'s 3 by ``expert_mlp``
    (router whole); seamless's vocabulary of 510 splits over 2, not 4."""
    def split_dims(key, m):
        cfg = _cfg(key)
        desc = LogicalMesh(("data", "model"), (W // m, m))
        params = _flat(abstract_state(cfg, RunConfig(), zoo.model_specs(cfg),
                                      desc, default_rules())["params"])
        return {k: tuple(i for i, e in enumerate(t.sharding.spec)
                         if e == "model") for k, t in params.items()}
    for m in (2, 4):
        for key in ("mixtral", "kimi"):
            got = split_dims(key, m)
            assert got["layers/moe/we1"] == (1,) and \
                got["layers/moe/router"] == (2,), (key, m, got)
        got = split_dims("mixtral-emlp", m)
        assert got["layers/moe/we1"] == (3,) and \
            got["layers/moe/we2"] == (2,) and \
            got["layers/moe/router"] == (), (m, got)
    assert split_dims("kimi", 4)["layers/moe/ws1"] == (2,)
    assert split_dims("seamless", 2)["embed"] == (0,)
    assert split_dims("seamless", 4)["embed"] == ()


@pytest.mark.parametrize("cid", IDS)
def test_tp_family_step_matches_reference_on_global_batch(
        ranks, reference, one_process, cid):
    """Every rank's step against the reference's one-device step on the
    global batch: every metric within METRIC_RTOL of the reference's, or
    no further from it than the port's own one-process step plus
    PORT_METRIC_RTOL; the gathered parameters bit-equal on the ranks and
    within SCALED of their scale, or no further from the reference than
    the one-process step plus PORT_PARAM_REL of it."""
    want_m, want_p = reference[cid]
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
def test_tp_family_step_matches_one_process_port(ranks, one_process, cid):
    """Against the port's one-process step on the global batch: metrics
    within PORT_METRIC_RTOL, parameters (and AdamW's first moment) within
    PORT_PARAM_REL of their scale.  Under AdamW fewer than FLIP_FRAC of a
    leaf's parameters may part further, each where the one-process first
    moment is within NOISE_REL of the leaf's largest: the sign of a
    gradient at f32's rounding noise."""
    want_m, want_p, want_mu = one_process[cid]
    got = ranks[0]["cases"][cid]
    for g, w in zip(got["metrics"], want_m):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=PORT_METRIC_RTOL,
                                       atol=1e-8, err_msg=k)
    _hold_params(got["params"], want_p, got["mu"], want_mu)


def _hold_params(got_p, want_p, got_mu, want_mu):
    """Parameters (by path) within PORT_PARAM_REL of their scale of
    ``want_p``; under AdamW (``want_mu``, the first moments) the moments
    too, and fewer than FLIP_FRAC of a leaf's parameters may part
    further, each where the wanted first moment is within NOISE_REL of
    the leaf's largest."""
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        far = np.abs(got_p[k] - w) > PORT_PARAM_REL * np.abs(w).max()
        if want_mu is None:
            assert not far.any(), k
            continue
        mu = want_mu[k]
        assert np.abs(got_mu[k] - mu).max() <= \
            PORT_PARAM_REL * np.abs(mu).max(), k
        assert far.mean() < FLIP_FRAC, (k, int(far.sum()))
        assert (np.abs(mu[far]) <= NOISE_REL * np.abs(mu).max()).all(), k


@pytest.mark.parametrize("cid", [c[0] for c in F64_CASES])
def test_tp_family_gradients_equal_one_process_in_float64(ranks, inputs,
                                                          cid):
    """At the fan_in weights, in float64: the loss on every rank and the
    gradient of every leaf (summed over the data line, gathered over the
    model line) against the one-process float64 step's, within F64_REL of
    the leaf's scale, the loss within PORT_METRIC_RTOL (the model's own
    f32 casts, in its norms, head and router, leave ~1e-7).  Some leaf
    of the case is split on the model line."""
    _, params64, batches = inputs
    key = next(c[2] for c in F64_CASES if c[0] == cid)
    cfg = _cfg(key, dtype="float64")
    params = optim.tree_map(lambda p: p.clone(), params64[key])
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in _tensors(batches[key]).items()}
    loss, _ = zoo.loss_fn(cfg)(params, batch)
    want = torch.autograd.grad(loss, leaves)
    for r in ranks:
        got_loss, got, split = r["f64"][cid]
        assert any(split)
        assert abs(got_loss - float(loss.detach())) <= \
            PORT_METRIC_RTOL * abs(float(loss.detach()))
        for g, w in zip(got, want):
            w = w.numpy()
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= F64_REL * np.abs(w).max()


@pytest.mark.parametrize("cid", IDS)
def test_tp_family_bytes_equal_abstract_state(ranks, cid):
    """Each rank holds exactly the shard bytes ``abstract_state``
    describes on the case's (data, model) mesh under
    ``default_rules(fsdp=...)``: the parameters, the optimizer state and
    the f32 accumulators (ZeRO-1's gradient shardings; plain DP: the
    model chunks whole on the data line)."""
    _, key, mesh, mode, optimizer, mb, remat = _case(cid)
    cfg, run = _cfg(key, remat), _run(mode, optimizer, mb)
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


@pytest.mark.parametrize("what", ["one_equal", "marked", "continues"])
def test_tp_moe_checkpoint_moves_between_ranks_and_one_process(ranks, what):
    """A 2 x 2 FSDP + TP checkpoint of the MoE holds the one-device
    layout: it restores into one process (equal to the gathered state),
    that process's checkpoint restores into the ranks' chunks (marked
    with their data and model splits) and step 2 from it is bit-equal
    to the uninterrupted step 2."""
    for r in ranks:
        if what in r["ckpt"]:
            assert r["ckpt"][what] is True, (what, r["ckpt"])


# ---------------------------------------------------------------- on cards
NCCL_W = 2


def _nccl_body(rank, device, params, batch):
    """Two NCCL ranks on (data 1, model 2), the reduced MoE (its experts
    split): two steps of AdamW in two microbatches (remat full), the
    gathered parameters and first moments; rank 0 also the one-card
    step on its card."""
    cfg, run = _cfg("mixtral", "full"), _run("plain", "adamw", 2)
    out = {}
    if rank == 0:
        state = init_state(cfg, run, params_from_reference(params,
                                                           device=device))
        step = build_train_step(cfg, run, total_steps=100)
        state, ms = _steps(step, state, {k: v.to(device) for k, v in
                                         _tensors(batch).items()})
        out["one"] = (ms, {k: _np(v) for k, v in
                           _flat(state["params"]).items()}, _moment(state))
    mesh = make_host_mesh(model_parallel=NCCL_W)
    state = init_state(cfg, run, params_from_reference(params,
                                                       device=device),
                       mesh=mesh)
    step = build_train_step(cfg, run, total_steps=100, mesh=mesh)
    state, ms = _steps(step, state, {k: v.to(device) for k, v in
                                     _local(mesh, batch).items()})
    out["tp"] = (ms, {k: _np(v) for k, v in _flat(
        elastic.gather_state(state["params"])).items()}, _moment(state))
    return out


@pytest.mark.gpu
def test_nccl_model_ranks_train_the_moe_as_one_card():
    """Two NCCL ranks, one card each, on the model axis (the reduced f32
    MoE, its experts split, matrices x SCALE, remat full): every metric
    within METRIC_RTOL and the gathered parameters and first moments
    held to the one-card step on the same global batch as
    ``test_tp_family_step_matches_one_process_port`` holds them."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < NCCL_W:
        pytest.skip(f"needs {NCCL_W} CUDA devices: NCCL takes one card a "
                    "rank")
    cfg = _cfg("mixtral")
    params = _scaled(optim.tree_map(
        lambda p: p.numpy(), init_params(
            zoo.model_specs(cfg), torch.Generator().manual_seed(0),
            "float32", device="cpu")))
    got = run_ranks(_nccl_body, NCCL_W, (params, _batch("mixtral")),
                    timeout_s=600)
    want_m, want_p, want_mu = got[0]["one"]
    for r in got:
        ms, ps, mus = r["tp"]
        for g, w in zip(ms, want_m):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                           atol=1e-8, err_msg=k)
        _hold_params(ps, want_p, mus, want_mu)
