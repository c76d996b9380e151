"""Tensor parallelism (the ``model`` axis over ranks) for the ssm
(mamba2) and hybrid (zamba2) families over W = 4 gloo ranks on the CPU,
composed with plain DP, ZeRO-1 and FSDP.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on the four ranks, on two meshes of them
(``make_host_mesh(model_parallel=...)``): (data 1, model 4) and (data 2,
model 2).  The configurations, each reduced and in f32:

* ``mamba2``: d_model 128, 16 SSM heads of 16, state 16, vocabulary 512
  with tied embeddings; every mixer leaf splits on ``ssm_inner``
  (``in_proj``'s 560 columns cut across its z | x | B | C | dt blocks,
  ``conv_w``'s 288 across x | B | C), and the tied embedding by
  vocabulary;
* ``mamba2-wide``: the same at state 15, so ``in_proj``'s 558 columns
  and the conv's 286 stay whole on a line of 4 while the heads split
  (the guard's degrade path; both split on a line of 2);
* ``mamba2-groups`` (float64 gradients only): d_model 96, 12 heads in 3
  groups of B and C, so a rank's heads read a slice of the groups or,
  where they take them unevenly (rank 1 of 4: heads 3-5 of groups 0, 1,
  1), one group a head;
* ``zamba2``: 4 mamba layers (of the reduced config's 8) in 2
  super-blocks of 2, each followed by the shared attention and MLP block
  (4 heads, d_ff 256, split as the dense family's) behind the whole
  ``shared_proj``.

Each rank passes its data coordinate's ``DataShard`` block of the global
batch (4 rows of 32 positions: two SSD chunks of 16).  The parent holds
the results to:

* the reference's one-device jitted step on the global batch, at
  ``test_train_step_matches_reference``'s bars (metrics 1e-5 relative,
  every parameter within ``SCALED`` of its scale), or no further from
  it than the port's own one-process step plus the port bars: AdamW at
  1 and 2 microbatches, on (2, 2) ZeRO-1, FSDP and Adafactor, 8-bit Adam
  for zamba2 on (1, 4).  The reference's step is compiled once per
  configuration, optimizer and microbatch count (four steps);
* the port's own one-process step at ``PORT_METRIC_RTOL`` and
  ``PORT_PARAM_REL``, every first moment too, with the AdamW sign-flip
  allowance of tests/test_torch_train_tp_families.py (``FLIP_FRAC``,
  ``NOISE_REL``), and under 8-bit Adam parting only on a moment code
  flipped by one step (in the state the last update was handed, or in
  the one it left; fewer than ``CODE_FLIP_FRAC`` of a leaf's codes), as
  tests/test_torch_train_tp.py allows.  Besides, AdamW's second
  update is ``lr * f`` with ``f = g / (|g| + eps)`` (the warm-up's lr is
  0 at step 0, so both steps take the same clipped gradient g): where g
  is near eps (the mixer's zero-initialised ``conv_b``, ``A_log`` and
  ``dt_bias`` after the clip divides the gradient by its norm of ~90), f
  turns the rounding of a held first moment into a larger parameter
  difference, so an element may also part by up to twice the
  difference of ``lr * f`` at the two steps' first moments (AdamW), or
  at the two steps' gradients fed to 8-bit Adam's update from the
  one-process state (8-bit: its gradients are recorded and held at
  ``PORT_PARAM_REL`` too);
* in float64, the one-process gradients, every block of ``in_proj`` and
  of the conv against its own scale.  The mixer computes its SSD scan
  and its gated norm in f32 inside a float64 model (as the reference
  does), so the one-process float64 gradient itself lies up to
  2.8e-6 of a block's scale from one computed in float64 throughout
  (mamba2; 1.0e-6–1.4e-6 for the others): the bar is
  ``F64_FLOOR_X`` x that floor, measured here for each configuration, or
  ``F64_REL`` where wider.

Besides: each rank's parameter, optimizer-state and accumulator bytes
equal ``abstract_state``'s shard bytes on the mesh; a 2 x 2 FSDP + TP
checkpoint of zamba2 restores into one process and back and continues
bit-equal; an SSM head count that does not divide the line raises
(ROADMAP Queue A item 11), and so do a mamba cache and decode under a
model line (item 10).  The matrices are scaled by ``SCALE``.  ``jax``
and ``repro`` are imported in the parent's fixtures only.  The ``gpu``
test runs two NCCL ranks on ``model`` where there are two cards.
"""
import dataclasses
import os
import tempfile
import unittest.mock as mock
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
from repro_torch.models import layers, mamba2, transformer, zoo
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
# each config's matrices x SCALE: the one-process f32 gradients lie up
# to 1.0e-5 (mamba2) of a leaf's scale from float64 ones at the fan_in
# weights, 1.4e-6 at x 0.5; zamba2's (its embeddings joined into every
# shared block) 4.4e-5 at x 0.5 and 2.7e-6 at x 0.25 (the CPU, one
# microbatch of the global batch)
SCALE = {"mamba2": 0.5, "mamba2-wide": 0.5, "mamba2-groups": 0.5,
         "zamba2": 0.25}
SCALED = 2e-3                   # as tests/test_torch_train.py
METRIC_RTOL = 1e-5              # against the reference
PORT_METRIC_RTOL = 1e-6         # against the port's one-process step
PORT_PARAM_REL = 2e-5           # of each parameter's scale, ditto
F64_REL = 1e-5                  # float64 gradients, of each leaf's scale
F64_FLOOR_X = 4.0               # x the one-process f32-inside-f64 floor
FLIP_FRAC = 1e-4                # of a leaf's elements, where signs flip
# of a leaf's 8-bit moment codes that may flip by one step over ranks:
# read at 2 of 16,384 (1.2e-4) on an AMD EPYC host (the shared block's
# wo, zamba2 tp4 plain), 0 elsewhere; a quantiser that rounds the other
# way flips about half
CODE_FLIP_FRAC = 1e-3
NOISE_REL = 1e-5                # of a leaf's largest first moment
LR = 5e-3
ROWS, SEQ = 4, 32
# config -> (arch, its changes to the reduced config, and to its SSM)
CONFIGS = {"mamba2": ("mamba2-780m", {}, {}),
           "mamba2-wide": ("mamba2-780m", {}, {"d_state": 15}),
           "mamba2-groups": ("mamba2-780m", {"d_model": 96}, {"n_groups": 3}),
           "zamba2": ("zamba2-2.7b", {"n_layers": 4, "shared_every": 2}, {})}
# (id, config, mesh, mode, optimizer, microbatches, remat)
CASES = [
    ("mamba2-tp4-plain-adamw-mb2", "mamba2", "tp4", "plain", "adamw", 2,
     "full"),
    ("mamba2-dp2tp2-zero1-adamw-mb2", "mamba2", "dp2tp2", "zero1", "adamw",
     2, "selective"),
    ("mamba2-wide-tp4-plain-adamw-mb1", "mamba2-wide", "tp4", "plain",
     "adamw", 1, "none"),
    ("zamba2-tp4-plain-adamw-mb1", "zamba2", "tp4", "plain", "adamw", 1,
     "none"),
    ("zamba2-dp2tp2-fsdp-adafactor-mb2", "zamba2", "dp2tp2", "fsdp",
     "adafactor", 2, "full"),
    ("zamba2-tp4-plain-adamw8bit-mb2", "zamba2", "tp4", "plain",
     "adamw8bit", 2, "selective"),
]
IDS = [c[0] for c in CASES]
# the cases held to the reference's step: ``mamba2-wide`` differs from
# mamba2 in the guard's split alone, so it is held to the port's own
# one-process step (and in float64), and its reference step is not
# compiled
REF_IDS = [c[0] for c in CASES if c[1] != "mamba2-wide"]
# float64 gradient checks: (id, mesh, config)
F64_CASES = [("mamba2-tp4", "tp4", "mamba2"),
             ("mamba2-dp2tp2", "dp2tp2", "mamba2"),
             ("mamba2-wide-tp4", "tp4", "mamba2-wide"),
             ("mamba2-groups-tp4", "tp4", "mamba2-groups"),
             ("mamba2-groups-dp2tp2", "dp2tp2", "mamba2-groups"),
             ("zamba2-tp4", "tp4", "zamba2"),
             ("zamba2-dp2tp2", "dp2tp2", "zamba2")]
REFUSALS = ["head-cut-step", "head-cut-state", "mamba2-prefill",
            "mamba2-decode", "zamba2-prefill"]


def _reduced(base, key, dtype="float32", remat="none"):
    """``key``'s reduced config from the reduced ``base`` (the port's or
    the reference's), in ``dtype`` at ``remat``."""
    _, changes, ssm = CONFIGS[key]
    return dataclasses.replace(base, dtype=dtype, remat=remat,
                               ssm=dataclasses.replace(base.ssm, **ssm),
                               **changes)


def _cfg(key, remat="none", dtype="float32"):
    return _reduced(get_arch(CONFIGS[key][0]).reduced(), key, dtype, remat)


def _head_cut():
    """Reduced mamba2 at d_model 96 with heads of 64: 3 heads over a
    d_inner of 192, which divides a line of 4 while the heads do not."""
    base = get_arch("mamba2-780m").reduced()
    return dataclasses.replace(base, d_model=96, ssm=dataclasses.replace(
        base.ssm, head_dim=64))


def _run(mode, optimizer, mb):
    return RunConfig(optimizer=optimizer, learning_rate=LR, microbatches=mb,
                     zero1=mode == "zero1", fsdp=mode == "fsdp")


def _case(cid):
    return next(c for c in CASES if c[0] == cid)


def _batch(key, seed=0):
    """The global batch: labels masked unevenly, so the data ranks'
    counts of unmasked labels differ in every microbatch."""
    cfg = _cfg(key)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (ROWS, SEQ)).astype(np.int32)}
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
    return t.detach().float().cpu().numpy().copy()


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in optim.tree_leaves(tree))


def _scaled(tree, key):
    """Every matrix (a leaf of 2 or more dims) times ``key``'s SCALE."""
    return optim.tree_map(lambda a: a * SCALE[key] if a.ndim >= 2 else a,
                          tree)


def _paths(tree, prefix="") -> list:
    """The "a/b" paths of ``tree``'s leaves in ``optim.tree_leaves``'
    (sorted-key) order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree)
                for q in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _steps(step, state, batch, n=2):
    ms = []
    for _ in range(n):
        state, m = step(state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    return state, ms


def _blocks(path: str, cfg) -> list:
    """(name, columns) of a leaf's blocks along its last dim: z, x, B, C
    and dt of ``in_proj``, x, B and C of the conv; the whole leaf else."""
    d_in, n_heads, conv_dim = mamba2.mamba_dims(cfg)
    gn = cfg.ssm.n_groups * cfg.ssm.d_state
    if path.endswith("mixer/in_proj"):
        cuts = [("z", d_in), ("x", d_in), ("B", gn), ("C", gn),
                ("dt", n_heads)]
    elif path.endswith(("mixer/conv_w", "mixer/conv_b")):
        cuts = [("x", d_in), ("B", gn), ("C", gn)]
    else:
        return [("", slice(None))]
    out, lo = [], 0
    for name, n in cuts:
        out.append((name, slice(lo, lo + n)))
        lo += n
    return out


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


def _moment(state):
    """AdamW's first moment by parameter path, whole (None for another
    optimizer)."""
    if "mu" not in state["opt"]:
        return None
    return {k: _np(v) for k, v in _flat(elastic.gather_state(
        state["opt"]["mu"])).items()}


def _codes(state):
    """8-bit Adam's moment codes by parameter path (None for another
    optimizer)."""
    if "q" not in state["opt"]:
        return None
    return {k: v.detach().numpy().copy() for k, v in _flat(
        state["opt"]["q"]).items() if k.endswith(("mu_q", "nu_q"))}


def _recorded(run, build):
    """``build()`` (a train step) with, under 8-bit Adam, its update
    recording the gradient and the state it is handed, leaf by leaf (a
    list the step fills; None for another optimizer)."""
    if run.optimizer != "adamw8bit":
        return build(), None
    init, update = optim.OPTIMIZERS[run.optimizer]
    seen = []

    def spy(grads, state, params, lr, **kw):
        seen.append((grads["x"].detach().clone(),
                     {k: v.clone() for k, v in state["q"]["x"].items()},
                     state["count"].clone()))
        return update(grads, state, params, lr, **kw)
    with mock.patch.dict(optim.OPTIMIZERS, {run.optimizer: (init, spy)}):
        return build(), seen


def _last_inputs(seen, paths):
    """The optimizer's inputs of the last step by leaf path, as numpy."""
    if seen is None:
        return None
    return {k: (g.numpy(), {n: v.numpy() for n, v in q.items()}, int(c))
            for k, (g, q, c) in zip(paths, seen[-len(paths):])}


def _cases(meshes, ref_params, batches):
    out = {}
    for cid, key, mesh, mode, optimizer, mb, remat in CASES:
        mesh = meshes[mesh]
        cfg, run = _cfg(key, remat), _run(mode, optimizer, mb)
        state = init_state(cfg, run, params_from_reference(
            ref_params[key], device="cpu"), mesh=mesh)
        step, seen = _recorded(run, lambda: build_train_step(
            cfg, run, total_steps=100, mesh=mesh))
        state, ms = _steps(step, state, _local(mesh, batches[key]))
        whole = elastic.gather_state(state["params"])
        out[cid] = {"metrics": ms,
                    "params": {k: _np(v) for k, v in _flat(whole).items()},
                    "same": _same_on_ranks(optim.tree_leaves(whole)),
                    "param_bytes": _nbytes(state["params"]),
                    "held_param_bytes": step.held["param_bytes"],
                    "opt_bytes": _nbytes(state["opt"]),
                    "acc_bytes": step.held["grad_acc_bytes"],
                    "mu": _moment(state), "codes": _codes(state),
                    "inputs": _last_inputs(seen, _paths(state["params"]))}
    return out


def _line(mesh):
    dgroup, dsize, _ = mesh.line(("data",))
    mgroup, msize, mindex = mesh.line(("model",))
    return dgroup, collective.DataParallel(
        dgroup, dsize, model=collective.ModelLine(mgroup, msize, mindex))


def _f64_grads(meshes, params64, batches):
    """Per F64_CASES entry the loss's float64 gradient on this rank's
    chunks, summed over the data line and gathered over the model line
    (the whole gradient)."""
    out = {}
    for cid, name, key in F64_CASES:
        mesh = meshes[name]
        cfg = _cfg(key, dtype="float64")
        chunks = shard_params(cfg, RunConfig(), params64[key], mesh)
        leaves = optim.tree_leaves(chunks)
        for p in leaves:
            p.requires_grad_(True)
        dgroup, dp = _line(mesh)
        local = _local(mesh, batches[key])
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
    """FSDP + TP AdamW on (2, 2), zamba2 (remat full, one microbatch):
    save at step 1 (four ranks),
    restore into one process (rank 0) and save from there, restore into
    the ranks' chunks and take step 2: bit-equal to the uninterrupted
    step 2."""
    cfg, run = _cfg("zamba2", "full"), _run("fsdp", "adamw", 1)
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
    a, b = os.path.join(tmp, "ssm_w4"), os.path.join(tmp, "ssm_w1")
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


def _refusals(mesh, ref_params):
    """What still raises on the (1, 4) line: a config whose SSM heads do
    not divide it (the step and the state), and a mamba cache (prefill)
    or decode step under a model line."""
    def raises(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None
    cut, run = _head_cut(), RunConfig()
    out = {"head-cut-step": raises(lambda: build_train_step(cut, run,
                                                            mesh=mesh)),
           "head-cut-state": raises(lambda: init_state(cut, run, {},
                                                       mesh=mesh))}
    _, dp = _line(mesh)
    tokens = torch.arange(2 * 8, dtype=torch.int32).reshape(2, 8)
    for key in ("mamba2", "zamba2"):
        cfg = _cfg(key)
        chunks = shard_params(cfg, run, params_from_reference(
            ref_params[key], device="cpu"), mesh)
        with collective.data_parallel(dp):
            out[key + "-prefill"] = raises(lambda: transformer.prefill(
                chunks, tokens, cfg, 16))
            if key == "mamba2":
                cache = transformer.init_cache(cfg, 2, 16, device="cpu")
                out[key + "-decode"] = raises(lambda: transformer.decode_step(
                    chunks, tokens[:, 0], cache, cfg))
    return out


def _rank_body(rank, device, ref_params, params64, batches, tmp):
    torch.set_num_threads(1)
    meshes = {k: make_host_mesh(model_parallel=m, device=device)
              for k, (_, m) in MESHES.items()}
    return {"cases": _cases(meshes, ref_params, batches),
            "f64": _f64_grads(meshes, params64, batches),
            "ckpt": _checkpoint_round_trip(rank, meshes["dp2tp2"],
                                           ref_params["zamba2"],
                                           batches["zamba2"], tmp),
            "refuse": _refusals(meshes["tp4"], ref_params)}


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
    SCALE; the leaves the specs keep in f32, the mixer's ``A_log``,
    ``dt_bias``, ``D`` and ``norm_w``, stay f32) and the global batch."""
    def draw(key, seed):
        return _scaled(optim.tree_map(lambda p: p.numpy(), init_params(
            zoo.model_specs(_cfg(key)), torch.Generator().manual_seed(seed),
            "float32", device="cpu")), key)
    ref, params64, batches = {}, {}, {}
    for key in CONFIGS:
        ref[key] = draw(key, 0)
        assert sorted(_flat(R.zoo.model_specs(_ref_cfg(R, key)))) == \
            sorted(_flat(ref[key]))
        params64[key] = _scaled(init_params(
            zoo.model_specs(_cfg(key)), torch.Generator().manual_seed(1),
            "float64", device="cpu"), key)
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
    batch, per case: compiled once per configuration, optimizer and
    microbatch count (its remat none: remat changes no value,
    tests/test_torch_train.py).  The warm-up's lr is 0 at step 0, so
    both steps' metrics read the initial parameters and the second
    step's update shows in the parameters."""
    ref_params, _, batches = inputs
    out = {}
    for cid, key, _, _, optimizer, mb, _ in map(_case, REF_IDS):
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
def one_thread():
    """torch on one thread while the module's fixtures run in the parent
    (its models are small, and the ranks and the other workers share
    the host's cores), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_process(inputs, one_thread):
    """The port's own one-process step on the global batch per case."""
    ref_params, _, batches = inputs
    out = {}
    for cid, key, _, mode, optimizer, mb, remat in CASES:
        cfg, run = _cfg(key, remat), _run(mode, optimizer, mb)
        state = init_state(cfg, run, params_from_reference(ref_params[key],
                                                           device="cpu"))
        step, seen = _recorded(run, lambda: build_train_step(
            cfg, run, total_steps=100))
        state, ms = _steps(step, state, _tensors(batches[key]))
        out[cid] = (ms, {k: _np(v) for k, v in
                         _flat(state["params"]).items()}, _moment(state),
                    _codes(state), _last_inputs(seen,
                                                _paths(state["params"])))
    return out


def _grads64(cfg, params64, batch):
    """(loss, the one-process float64 gradients by path)."""
    params = optim.tree_map(lambda p: p.clone(), params64)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg)(params, {
        k: v.double() if v.is_floating_point() else v
        for k, v in _tensors(batch).items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), dict(zip(_paths(params),
                                          (g.numpy() for g in grads)))


@pytest.fixture(scope="module")
def float64(inputs, one_thread):
    """Per config the one-process float64 loss and gradients, and the
    floor: the largest distance, relative to its block's scale, between
    those gradients and the ones computed with the mixer's and the
    norms' f32 casts made float64 too."""
    _, params64, batches = inputs
    out = {}
    for key in sorted({c[2] for c in F64_CASES}):
        cfg = _cfg(key, dtype="float64")
        loss, grads = _grads64(cfg, params64[key], batches[key])
        with mock.patch.object(mamba2, "F32", torch.float64), \
                mock.patch.object(layers, "F32", torch.float64), \
                mock.patch.object(transformer, "F32", torch.float64):
            _, wide = _grads64(cfg, params64[key], batches[key])
        floor = max(np.abs(grads[k][..., c] - wide[k][..., c]).max()
                    / np.abs(wide[k][..., c]).max()
                    for k in grads for _, c in _blocks(k, cfg))
        out[key] = (loss, grads, floor)
    return out


# ------------------------------------------------------------------ tests
def test_configs_take_the_mixer_splits():
    """The guard splits every mixer leaf of reduced mamba2 on both lines
    (the tied embedding by vocabulary), leaves ``mamba2-wide``'s
    ``in_proj`` and conv whole on 4 and splits them on 2, and leaves
    zamba2's ``shared_proj`` whole while its shared block splits."""
    def split_dims(key, m):
        cfg = _cfg(key)
        desc = LogicalMesh(("data", "model"), (W // m, m))
        params = _flat(abstract_state(cfg, RunConfig(), zoo.model_specs(cfg),
                                      desc, default_rules())["params"])
        return {k: tuple(i for i, e in enumerate(t.sharding.spec)
                         if e == "model") for k, t in params.items()}
    mixer = {"in_proj": (2,), "conv_w": (2,), "conv_b": (1,),
             "A_log": (1,), "dt_bias": (1,), "D": (1,), "norm_w": (1,),
             "out_proj": (1,)}
    for m in (2, 4):
        got = split_dims("mamba2", m)
        assert {k: got["layers/mixer/" + k] for k in mixer} == mixer
        assert got["embed"] == (0,) and "lm_head" not in got
    wide4, wide2 = split_dims("mamba2-wide", 4), split_dims("mamba2-wide", 2)
    for k in ("in_proj", "conv_w", "conv_b"):
        assert wide4["layers/mixer/" + k] == ()
        assert wide2["layers/mixer/" + k] == mixer[k]
    assert wide4["layers/mixer/A_log"] == (1,)
    got = split_dims("zamba2", 4)
    assert got["shared_proj"] == () and got["shared/attn/wq"] == (1,) \
        and got["shared/mlp/w1"] == (1,)


@pytest.mark.parametrize("cid", REF_IDS)
def test_tp_ssm_step_matches_reference_on_global_batch(
        ranks, reference, one_process, cid):
    """Every rank's step against the reference's one-device step on the
    global batch: every metric within METRIC_RTOL of the reference's, or
    no further from it than the port's own one-process step plus
    PORT_METRIC_RTOL; the gathered parameters bit-equal on the ranks and
    within SCALED of their scale, or no further from the reference than
    the one-process step plus PORT_PARAM_REL of it."""
    want_m, want_p = reference[cid]
    port_m, port_p = one_process[cid][:2]
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
def test_tp_ssm_step_matches_one_process_port(ranks, one_process, cid):
    """Against the port's one-process step on the global batch: metrics
    within PORT_METRIC_RTOL, parameters (and AdamW's first moment) within
    PORT_PARAM_REL of their scale.  Under AdamW fewer than FLIP_FRAC of a
    leaf's parameters may part further, each where the one-process first
    moment is within NOISE_REL of the leaf's largest; under 8-bit Adam
    a moment code may differ only by one step (a rounding flip), in the
    state the last update was handed and in the one it left, at fewer
    than CODE_FLIP_FRAC of a leaf's codes, and fewer than FLIP_FRAC of a
    leaf's parameters may part further, each where a code of either
    state flipped, as tests/test_torch_train_tp.py holds them.  (A code
    flipped in the handed state moves the last update and can be
    rounded back by it: on an AMD EPYC host one ``nu_q`` code of
    zamba2's ``out_proj`` does so, and its parameter parts by 3.5e-6
    against a bar of 1.4e-6; two of the 16,384 final ``nu_q`` codes of
    the shared block's ``wo`` flip there, past FLIP_FRAC, the earlier
    bar on codes.)"""
    want_m, want_p, want_mu, want_q, want_in = one_process[cid]
    got = ranks[0]["cases"][cid]
    for g, w in zip(got["metrics"], want_m):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=PORT_METRIC_RTOL,
                                       atol=1e-8, err_msg=k)
    if want_q is None:
        _hold_params(got["params"], want_p, got["mu"], want_mu)
        return
    assert sorted(got["codes"]) == sorted(want_q)
    for k, w in want_p.items():
        g, want_g = got["inputs"][k][0], want_in[k][0]
        assert np.abs(g - want_g).max() <= \
            PORT_PARAM_REL * np.abs(want_g).max(), k
        far = np.abs(got["params"][k] - w) > PORT_PARAM_REL * np.abs(w).max()
        far &= np.abs(got["params"][k] - w) > PORT_PARAM_REL * np.abs(
            w).max() + 2 * _eight_bit_spread(want_in[k], g)
        flipped = np.zeros(w.size, dtype=bool)
        for part in ("mu_q", "nu_q"):
            for a, b in ((got["codes"][f"{k}/{part}"], want_q[f"{k}/{part}"]),
                         (got["inputs"][k][1][part], want_in[k][1][part])):
                step = np.abs(a.astype(np.int16) - b.astype(np.int16))
                assert step.max() <= 1, (k, part)   # adjacent codes only
                assert (step != 0).mean() < CODE_FLIP_FRAC, \
                    (k, part, int((step != 0).sum()), step.size)
                flipped |= (step != 0).reshape(-1)[:w.size]
        assert far.mean() < FLIP_FRAC, (k, int(far.sum()))
        assert not (far.reshape(-1) & ~flipped).any(), k


def _step_lr() -> float:
    """The second step's learning rate (the warm-up's first nonzero)."""
    return float(optim.lr_schedule(LR, total=100)(1))


def _adamw_spread(mu_a, mu_b, b1=0.9, eps=1e-8):
    """|lr * (f(a) - f(b))| by element, f = g / (|g| + eps) the second
    step's AdamW direction at the clipped gradient g = mu / (1 - b1**2)
    of each first moment (the same g at both steps: sqrt(nu-hat) = |g|)."""
    def f(mu):
        g = mu.astype(np.float64) / (1 - b1 ** 2)
        return g / (np.abs(g) + eps)
    return _step_lr() * np.abs(f(mu_a) - f(mu_b))


def _eight_bit_spread(inputs, g):
    """|u(g) - u(g0)| by element: 8-bit Adam's update (weight decay
    aside) from the one-process step's state ``inputs`` = (g0, codes and
    scales, count) at the gradient g and at its own g0."""
    g0, q, count = inputs

    def u(grad):
        state = {"q": {"x": {k: torch.from_numpy(v.copy())
                             for k, v in q.items()}},
                 "count": torch.tensor(count, dtype=torch.int32)}
        upd, _ = optim.adam8bit_update(
            {"x": torch.from_numpy(grad)}, state,
            {"x": torch.zeros(grad.shape)}, _step_lr(), weight_decay=0.0)
        return upd["x"].double().numpy()
    return np.abs(u(g) - u(g0))


def _hold_params(got_p, want_p, got_mu, want_mu):
    """Parameters (by path) within PORT_PARAM_REL of their scale of
    ``want_p``; under AdamW (``want_mu``, the first moments) the moments
    too, and a parameter may part further by up to twice the difference
    of the second update at the two first moments (:func:`_adamw_spread`:
    AdamW's eps regime), or else, for fewer than FLIP_FRAC of a leaf's
    parameters, where the wanted first moment is within NOISE_REL of the
    leaf's largest (a sign flip at f32's rounding noise)."""
    assert sorted(got_p) == sorted(want_p)
    for k, w in want_p.items():
        bar = PORT_PARAM_REL * np.abs(w).max()
        far = np.abs(got_p[k] - w) > bar
        if want_mu is None:
            assert not far.any(), k
            continue
        mu = want_mu[k]
        assert np.abs(got_mu[k] - mu).max() <= \
            PORT_PARAM_REL * np.abs(mu).max(), k
        far &= np.abs(got_p[k] - w) > bar + 2 * _adamw_spread(got_mu[k], mu)
        assert far.mean() < FLIP_FRAC, (k, int(far.sum()))
        assert (np.abs(mu[far]) <= NOISE_REL * np.abs(mu).max()).all(), k


@pytest.mark.parametrize("key", sorted({c[2] for c in F64_CASES}))
def test_f32_inside_float64_floor(float64, key):
    """The mixer's f32 SSD scan and gated norm (and the norms' f32 math)
    move the one-process float64 gradient by a measured floor: nonzero,
    and under F64_REL x 2 (2.8e-6 for mamba2, 1.0e-6–1.4e-6 for the
    others at SCALE): the bar of the float64 comparison is F64_FLOOR_X x
    it, or F64_REL where wider."""
    floor = float64[key][2]
    assert 0.0 < floor < 2 * F64_REL, floor


@pytest.mark.parametrize("cid", [c[0] for c in F64_CASES])
def test_tp_ssm_gradients_equal_one_process_in_float64(ranks, float64, cid):
    """In float64: the loss on every rank within PORT_METRIC_RTOL of the
    one-process loss, and the gradient of every leaf (summed over the
    data line, gathered over the model line) against the one-process
    float64 gradient, each block of ``in_proj`` (z, x, B, C, dt) and of
    the conv (x, B, C) against its own scale, within F64_FLOOR_X x the
    configuration's f32-inside-f64 floor (or F64_REL where wider).  The
    mixer's leaves and the tied embedding are split on the model line
    (mamba2), and zamba2's shared block too."""
    key = next(c[2] for c in F64_CASES if c[0] == cid)
    cfg = _cfg(key, dtype="float64")
    loss, want, floor = float64[key]
    bar = max(F64_REL, F64_FLOOR_X * floor)
    paths = list(want)
    for r in ranks:
        got_loss, got, split = r["f64"][cid]
        split = dict(zip(paths, split))
        assert split["layers/mixer/A_log"] and split["embed"]
        if key == "zamba2":
            assert split["shared/attn/wq"] and not split["shared_proj"]
        assert abs(got_loss - loss) <= PORT_METRIC_RTOL * abs(loss)
        for k, g in zip(paths, got):
            w = want[k]
            assert g.shape == w.shape, k
            for name, c in _blocks(k, cfg):
                assert np.abs(g[..., c] - w[..., c]).max() <= \
                    bar * np.abs(w[..., c]).max(), (k, name)


@pytest.mark.parametrize("cid", IDS)
def test_tp_ssm_bytes_equal_abstract_state(ranks, cid):
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
def test_tp_hybrid_checkpoint_moves_between_ranks_and_one_process(ranks,
                                                                  what):
    """A 2 x 2 FSDP + TP checkpoint of zamba2 holds the one-device
    layout: it restores into one process (equal to the gathered state),
    that process's checkpoint restores into the ranks' chunks (marked
    with their data and model splits) and step 2 from it is bit-equal
    to the uninterrupted step 2."""
    for r in ranks:
        if what in r["ckpt"]:
            assert r["ckpt"][what] is True, (what, r["ckpt"])


def test_ssd_gradient_stays_finite_past_exp_overflow(R):
    """At mamba2's chunk of 256 and dt ~0.7 a chunk's decays sum past
    exp's f32 range: the reference's SSD masks exp(seg) after taking it,
    so its gradient is 0 * inf = NaN there (a reference-side fault; the
    one-card mamba2 step at full width read a NaN grad norm); the port
    masks before the exp: the same outputs as the reference's, and a
    finite gradient (by dt, through the decays) equal to the one
    computed in float64 throughout."""
    from repro.models import mamba2 as rmamba2
    rng = np.random.default_rng(3)
    b, s, h, p, n, chunk = 1, 512, 2, 4, 4, 256
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.7, np.float32)
    a_neg = np.array([-1.0, -0.5], np.float32)
    bm, cm = (rng.normal(0, 1, (b, s, 1, n)).astype(np.float32)
              for _ in range(2))

    def ref_loss(dt_):
        y, _ = rmamba2.ssd_chunked(R.jnp.asarray(x), dt_, R.jnp.asarray(a_neg),
                                   R.jnp.asarray(bm), R.jnp.asarray(cm), chunk)
        return R.jnp.sum(y)
    ref_y, _ = rmamba2.ssd_chunked(*(R.jnp.asarray(t) for t in
                                     (x, dt, a_neg, bm, cm)), chunk)
    assert np.isnan(np.asarray(R.jax.grad(ref_loss)(R.jnp.asarray(dt)))).any()

    def port_grad(dtype):
        x_, dt_, a_, b_, c_ = (torch.from_numpy(t).to(dtype)
                               for t in (x, dt, a_neg, bm, cm))
        dt_.requires_grad_(True)
        y, _ = mamba2.ssd_chunked(x_, dt_, a_, b_, c_, chunk)
        return y, torch.autograd.grad(y.sum(), dt_)[0].double().numpy()
    y, g = port_grad(torch.float32)
    ref_y = np.asarray(ref_y)
    assert np.abs(y.detach().numpy() - ref_y).max() <= \
        F64_REL * np.abs(ref_y).max()
    with mock.patch.object(mamba2, "F32", torch.float64):
        _, want = port_grad(torch.float64)
    assert np.isfinite(g).all()
    assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("what", REFUSALS)
def test_tp_ssm_refusals(ranks, what):
    """An SSM head count that does not divide the model line raises in
    the step and in the state, naming ROADMAP Queue A item 11 (3 heads
    over a d_inner of 192 on a line of 4); a mamba cache (the ssm and
    hybrid prefill) and the mamba decode step under a model line raise
    naming item 10."""
    item = "item 11" if what.startswith("head-cut") else "item 10"
    for r in ranks:
        got = r["refuse"][what]
        assert got is not None and item in got, (what, got)


# ---------------------------------------------------------------- on cards
NCCL_W = 2


def _nccl_body(rank, device, params, batch):
    """Two NCCL ranks on (data 1, model 2), reduced zamba2 (its mixers
    split, the shared attention's 2 heads a rank through the flash
    kernel): two steps of AdamW in two microbatches (remat full), the
    gathered parameters and first moments; rank 0 also the one-card
    step on its card."""
    cfg, run = _cfg("zamba2", "full"), _run("plain", "adamw", 2)
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
def test_nccl_model_ranks_train_the_hybrid_as_one_card():
    """Two NCCL ranks, one card each, on the model axis (reduced f32
    zamba2, matrices x SCALE, remat full): every metric within
    METRIC_RTOL and the gathered parameters and first moments held to
    the one-card step on the same global batch as
    ``test_tp_ssm_step_matches_one_process_port`` holds them."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < NCCL_W:
        pytest.skip(f"needs {NCCL_W} CUDA devices: NCCL takes one card a "
                    "rank")
    cfg = _cfg("zamba2")
    params = _scaled(optim.tree_map(
        lambda p: p.numpy(), init_params(
            zoo.model_specs(cfg), torch.Generator().manual_seed(0),
            "float32", device="cpu")), "zamba2")
    got = run_ranks(_nccl_body, NCCL_W, (params, _batch("zamba2")),
                    timeout_s=600)
    want_m, want_p, want_mu = got[0]["one"]
    for r in got:
        ms, ps, mus = r["tp"]
        for g, w in zip(ms, want_m):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                           atol=1e-8, err_msg=k)
        _hold_params(ps, want_p, mus, want_mu)
