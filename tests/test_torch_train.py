"""The port's training path against the reference's, on the CPU.

Every input is made with numpy from a seed and handed to both packages;
the reference's parameters come over through ``params_from_reference``.
Held here: each family's loss and every gradient (``lm_loss`` /
``encdec_loss`` against ``jax.value_and_grad``, f32 ``reduced()``
configs, each gradient within ``SCALED`` of its own largest magnitude),
the three remat modes, the differentiable flash attention, the three
optimizers and 8-bit quantization, int8 compression, the train step
(one step, microbatches), the token pipeline, checkpoints (each
package's restoring in the other) and the fault-tolerant loop.  The
reference is imported inside the ``R`` fixture, so the ``gpu`` test
(the flash gradient and a train step on the card against the CPU port)
runs where JAX is absent.
"""
import dataclasses
import functools
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import RunConfig, ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import (DataShard, TokenPipeline,
                                       _batch_for_step, _extra_inputs)
from repro_torch.kernels import ops
from repro_torch.models import layers, transformer, zoo
from repro_torch.models.params import init_params
from repro_torch.runtime.fault import FaultConfig, run_training
from repro_torch.train import compress, optim
from repro_torch.train.step import (_sorted, build_train_step, global_norm,
                                    init_state)

# the families' reduced configs the losses are held on (one per family)
FAMILIES = ["llama3-8b", "mixtral-8x7b", "mamba2-780m", "zamba2-2.7b",
            "llava-next-34b", "seamless-m4t-large-v2"]
B, S, SRC = 2, 24, 20           # batch, tokens, encdec source frames
# as tests/test_torch_models.py: max |diff| within this fraction of the
# compared tensor's largest magnitude (f32 summation order differs)
SCALED = 2e-3
OPT_RTOL = 1e-6                 # optimizer updates and states, f32
STEP_RTOL = 1e-5                # the step's metrics against the reference
NORM_FLOOR_X = 4                # the grad norm's bar, in floors (below)
CELL = ShapeCell("t", 16, 4, "train")


@pytest.fixture(scope="module")
def R():
    """jax, jax.numpy and the reference's training modules."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.ckpt import checkpoint as rckpt
    from repro.configs import base, registry
    from repro.data import pipeline
    from repro.models import params, zoo as rzoo
    from repro.runtime import fault
    from repro.train import compress as rcompress, optim as roptim
    from repro.train import step as rstep
    return SimpleNamespace(jax=jax, jnp=jnp, base=base, ARCHS=registry.ARCHS,
                           zoo=rzoo, init=params.init_params, optim=roptim,
                           compress=rcompress, step=rstep, pipeline=pipeline,
                           ckpt=rckpt, fault=fault)


def _close_scaled(got, want, rel=SCALED, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * {scale}"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _ref_params(R, rcfg, seed=0):
    """The reference's own initial parameters.  (A MoE router is left
    as drawn: scaled by 50, as the serving tests scale it, the router
    z-loss reaches ~1.6e4 and its f32 rounding dominates every
    gradient.)"""
    return R.init(R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(seed),
                  rcfg.dtype)


def _port_params(R, rp, dtype=None, specs=None):
    return params_from_reference(R.jax.tree.map(np.asarray, rp),
                                 device="cpu", dtype=dtype, specs=specs)


def _loss_batch(cfg, seed=0):
    """Tokens and labels (B, S) with a few labels masked (-1), plus the
    vlm's prefix embeddings or the encdec's source frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][:, :3] = -1
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(
            0, 0.02, (B, SRC, cfg.d_model)).astype(np.float32)
    return out


def _both(R, batch):
    return ({k: R.jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _f32(R, name):
    return (dataclasses.replace(R.ARCHS[name].reduced(), dtype="float32"),
            dataclasses.replace(get_arch(name).reduced(), dtype="float32"))


def _grads(cfg, tp, batch):
    leaves = optim.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = zoo.loss_fn(cfg)(tp, batch)
    g = torch.autograd.grad(loss, leaves)
    it = iter(g)
    return loss, metrics, optim.tree_map(lambda _: next(it),
                                         _sorted(tp))


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(R, name):
    """lm_loss / encdec_loss and every parameter's gradient against
    jax.value_and_grad of the reference's loss: loss and metrics within
    1e-5 relative; each gradient within SCALED of its scale of the
    reference's, or else held to the f64 answer (the port in float64 on
    the same inputs) no further from it than 4x the reference's own f32
    gradient: random fan_in weights make activations ~100 and saturate
    softmaxes, so f32 rounding is amplified (llava's draw: both f32
    gradients 0.4-1.3% from f64)."""
    rcfg, cfg = _f32(R, name)
    rp = _ref_params(R, rcfg)
    jb, tb = _both(R, _loss_batch(cfg))
    (lj, mj), gj = R.jax.value_and_grad(R.zoo.loss_fn(rcfg), has_aux=True)(
        rp, jb)
    loss, metrics, gt = _grads(cfg, _port_params(R, rp), tb)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    assert sorted(metrics) == sorted(mj)
    for k in mj:
        np.testing.assert_allclose(float(metrics[k].detach()), float(mj[k]),
                                   rtol=1e-5, atol=1e-7)
    want = _flat(R.jax.tree.map(np.asarray, gj))
    got = _flat(gt)
    assert sorted(got) == sorted(want)
    truth = None
    for k in want:
        g = _np(got[k])
        assert g.shape == want[k].shape and np.isfinite(g).all(), k
        if np.abs(g - want[k]).max() <= SCALED * np.abs(want[k]).max():
            continue
        if truth is None:
            p64 = optim.tree_map(lambda a: a.detach().double(),
                                 _port_params(R, rp))
            b64 = {n: v.double() if v.is_floating_point() else v
                   for n, v in tb.items()}
            truth = _flat(_grads(dataclasses.replace(cfg, dtype="float64"),
                                 p64, b64)[2])
        t64 = truth[k].detach().numpy()
        e_port, e_ref = np.abs(g - t64).max(), np.abs(want[k] - t64).max()
        assert e_port <= 4 * e_ref, f"{k}: {e_port} from f64 > 4 x {e_ref}"


@pytest.mark.parametrize("name", ["llama3-8b", "mixtral-8x7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_remat_modes_give_equal_gradients(name):
    """none / full / selective remat: the same loss and bit-equal
    gradients (the recompute repeats the forward's operations)."""
    base = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch(base, 3).items()}
    out = {}
    for mode in ("none", "full", "selective"):
        cfg = dataclasses.replace(base, remat=mode)
        tp = init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(1),
                         "float32", device="cpu")
        out[mode] = _grads(cfg, tp, batch)
    for mode in ("full", "selective"):
        assert torch.equal(out[mode][0], out["none"][0])
        for a, b in zip(optim.tree_leaves(out[mode][2]),
                        optim.tree_leaves(out["none"][2])):
            assert torch.equal(a, b)


def _backward_bmms(mode):
    """aten.bmm calls (batch 1, batch > 1) during the backward pass of
    the reduced llama's loss under ``mode``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="float32", remat=mode)
    tp = init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(1),
                     "float32", device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch(cfg, 3).items()}
    leaves = optim.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = zoo.loss_fn(cfg)(tp, batch)
    seen = [0, 0]

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                seen[args[0].shape[0] > 1] += 1
            return func(*args, **(kwargs or {}))

    with Spy():
        torch.autograd.grad(loss, leaves)
    return tuple(seen)


def test_selective_remat_saves_projections_and_recomputes_attention():
    """The selective policy (the reference's
    dots_with_no_batch_dims_saveable): in the backward pass, full remat
    reruns every forward product; selective reruns the attention's
    batched products but none of the batch-1 projection einsums."""
    none, full, sel = (_backward_bmms(m) for m in ("none", "full",
                                                   "selective"))
    cfg = get_arch("llama3-8b").reduced()
    # per layer: q, k, v, o projections (batch 1); scores, mix (batched)
    assert full == (none[0] + 4 * cfg.n_layers, none[1] + 2 * cfg.n_layers)
    assert sel == (none[0], none[1] + 2 * cfg.n_layers)


# -------------------------------------------------- differentiable attention
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("sq", [24, 40])
def test_flash_function_grads_match_plain_attention(window, sq):
    """layers.flash_attention on CPU tensors (forward: the kernel's plain
    version flash_attention_ref) against autograd through
    transformer.plain_attention: outputs within 1e-5, q/k/v gradients
    bit-equal (its backward is the plain attention's vector-Jacobian
    product)."""
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="float32", sliding_window=window,
                              attn_impl="chunked", attn_chunk=16)
    rng = np.random.default_rng(sq)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, sq, h, 16)).astype(
        np.float32)).requires_grad_(True) for h in (8, 2, 2))
    plain = functools.partial(transformer.plain_attention, cfg=cfg)
    go = torch.from_numpy(rng.normal(size=(2, sq, 8, 16)).astype(np.float32))
    o = layers.flash_attention(q, k, v, plain, causal=True, window=window)
    got = torch.autograd.grad(o, (q, k, v), go)
    o_plain = plain(q, k, v)
    want = torch.autograd.grad(o_plain, (q, k, v), go)
    np.testing.assert_allclose(o.detach().numpy(), o_plain.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_function_counts_one_launch_a_call(monkeypatch):
    """The forward is one ops.flash_attention call; the backward calls
    it no more (it is plain torch)."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.randn(1, 16, 2, 16, requires_grad=True)
               for _ in range(3))
    plain = functools.partial(transformer.plain_attention,
                              cfg=get_arch("llama3-8b").reduced())
    layers.flash_attention(q, k, v, plain).sum().backward()
    assert len(calls) == 1
    assert all(t.grad is not None for t in (q, k, v))


# --------------------------------------------------------------- optimizers
def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 40), "stack": {"a": (3, 5, 7)}, "b": (300,),
              "s": ()}
    params = _draw(shapes, rng)
    grads = [_draw(shapes, rng) for _ in range(3)]
    return params, grads


def _draw(shapes, rng):
    if isinstance(shapes, dict):
        return {k: _draw(v, rng) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * 0.1).astype(np.float32)


def _to_t(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw8bit"])
def test_optimizer_updates_match_reference(R, name):
    """Three successive updates on the same grads and state: updates and
    every state tensor within rtol 1e-6 (f32), the 8-bit codes
    bit-equal, the count equal."""
    params, grads = _opt_inputs(4)
    rinit, rupd = R.optim.OPTIMIZERS[name]
    tinit, tupd = optim.OPTIMIZERS[name]
    jp = R.jax.tree.map(R.jnp.asarray, params)
    tp = _to_t(params)
    js, ts = rinit(jp), tinit(tp)
    for i, g in enumerate(grads):
        lr = np.float32(1e-3 * (i + 1))
        ju, js = rupd(R.jax.tree.map(R.jnp.asarray, g), js, jp, lr)
        tu, ts = tupd(_to_t(g), ts, tp, torch.tensor(lr))
        for k, want in _flat(R.jax.tree.map(np.asarray, ju)).items():
            np.testing.assert_allclose(_np(_flat(tu)[k]), want,
                                       rtol=OPT_RTOL, atol=1e-12, err_msg=k)
        got_s = _flat(ts)
        for k, want in _flat(R.jax.tree.map(np.asarray, js)).items():
            got = got_s[k]
            if want.dtype == np.int8 or k == "count":
                np.testing.assert_array_equal(_np(got), want, err_msg=k)
                assert got.dtype == {np.dtype(np.int8): torch.int8,
                                     np.dtype(np.int32): torch.int32}[
                                         want.dtype]
            else:
                np.testing.assert_allclose(_np(got), want, rtol=OPT_RTOL,
                                           atol=1e-30, err_msg=k)


def test_optimizer_apply_adds_updates_in_place():
    """apply=True adds each leaf's update to its parameter in place,
    (p.float() + u).to(p.dtype), as the step's reference does."""
    params, grads = _opt_inputs(7)
    p1 = optim.tree_map(lambda a: a.to(torch.bfloat16), _to_t(params))
    p2 = optim.tree_map(lambda a: a.clone(), p1)
    s1, s2 = optim.adamw_init(p1), optim.adamw_init(p2)
    lr = torch.tensor(1e-2)
    u, _ = optim.adamw_update(_to_t(grads[0]), s1, p1, lr)
    ptr = optim.tree_map(lambda a: a.data_ptr(), p2)
    none, _ = optim.adamw_update(_to_t(grads[0]), s2, p2, lr, apply=True)
    assert none is None
    for a, b, du, pt in zip(*(optim.tree_leaves(t) for t in
                              (p1, p2, u, ptr))):
        assert b.data_ptr() == pt
        assert torch.equal((a.float() + du).to(a.dtype), b)


def test_quantize_blockwise_bit_equal(R):
    """Codes bit-equal, scales equal, and the round trip within one
    step of the scale (the twin of tests/test_substrate.py:66)."""
    x = (np.random.default_rng(0).normal(size=(1000,)) * 3).astype(
        np.float32)
    x[5] = 0.5 * 3 / 127 * 1      # near a rounding tie
    qj, sj = R.optim.quantize_blockwise(R.jnp.asarray(x))
    qt, st = optim.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    y = optim.dequantize_blockwise(qt, st, x.shape)
    np.testing.assert_array_equal(y.numpy(), np.asarray(
        R.optim.dequantize_blockwise(qj, sj, x.shape)))
    assert float(np.max(np.abs(x - y.numpy()))) <= \
        float(np.max(np.abs(x))) / 127 + 1e-6


def test_lr_schedule_matches_reference(R):
    ref = R.optim.lr_schedule(3e-4, warmup=10, total=100)
    got = optim.lr_schedule(3e-4, warmup=10, total=100)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(got(s)), float(ref(s)), rtol=1e-6)
        np.testing.assert_allclose(float(got(torch.tensor(s, dtype=torch.int32))),
                                   float(ref(s)), rtol=1e-6)


# -------------------------------------------------------------- compression
def test_int8_compression_bit_equal_given_reference_uniforms(R):
    """compress_leaf fed the uniforms jax.random.uniform draws for the
    reference's split keys gives the reference's output bit for bit."""
    rng = np.random.default_rng(2)
    grads = {"w": rng.normal(size=(37, 11)).astype(np.float32),
             "b": (rng.normal(size=(64,)) * 1e-3).astype(np.float32),
             "z": np.full((5,), 0.3711, np.float32)}
    key = R.jax.random.PRNGKey(9)
    want = R.compress.int8_compress_decompress(
        R.jax.tree.map(R.jnp.asarray, grads), key)
    leaves = R.jax.tree.leaves(grads)
    keys = R.jax.random.split(key, len(leaves))
    for name, k in zip(sorted(grads), keys):
        u = np.asarray(R.jax.random.uniform(k, grads[name].shape))
        got = compress.compress_leaf(torch.from_numpy(grads[name]),
                                     torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[name]))


def test_int8_compression_unbiased_and_in_place():
    """Stochastic rounding is unbiased (the twin of
    tests/test_substrate.py:73), and the tree is compressed in place."""
    outs = []
    for i in range(64):
        g = {"w": torch.full((512,), 0.3711)}
        ptr = g["w"].data_ptr()
        out = compress.int8_compress_decompress(
            g, torch.Generator().manual_seed(i))
        assert out is g and g["w"].data_ptr() == ptr
        outs.append(g["w"])
    assert abs(float(torch.stack(outs).mean()) - 0.3711) < 2e-3


# --------------------------------------------------------------- train step
def _step_pair(R, run, seed=0):
    rcfg, cfg = _f32(R, "llama3-8b")
    rp = R.init(R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(seed),
                "float32")
    rb = R.zoo.make_batch(rcfg, CELL, 0)
    tb = zoo.make_batch(cfg, CELL, 0, device="cpu")
    return (R.step.init_state(rcfg, R.base.RunConfig(**dataclasses.asdict(
        run)), rp), rb, rcfg), (init_state(cfg, run, _port_params(R, rp)),
                                tb, cfg)


@pytest.fixture(scope="module")
def norm_floor(R):
    """How far the reference's own f32 gradient norm moves when its sums
    are regrouped, relative to it: the largest of its gradient jitted
    against run op by op, and of one microbatch against two (on the
    step's first parameters and batch)."""
    run = RunConfig(learning_rate=5e-3)
    (js, jb, rcfg), _ = _step_pair(R, run)
    grad = R.jax.value_and_grad(R.zoo.loss_fn(rcfg), has_aux=True)
    norms = [float(R.step.global_norm(g(js["params"], jb)[1]))
             for g in (R.jax.jit(grad), grad)]
    for mb in (1, 2):
        rrun = R.base.RunConfig(**dataclasses.asdict(
            dataclasses.replace(run, microbatches=mb)))
        _, m = R.jax.jit(R.step.build_train_step(rcfg, rrun, total_steps=100))(
            R.step.init_state(rcfg, rrun, js["params"]), jb)
        norms.append(float(m["grad_norm"]))
    return (max(norms) - min(norms)) / norms[0]


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "adamw8bit"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(R, norm_floor, optimizer,
                                      microbatches):
    """Two steps of build_train_step on the reference's parameters and
    batch: loss, lr and the loss's metrics within STEP_RTOL relative,
    every updated parameter within SCALED of its scale (the twins of
    tests/test_substrate.py:33 and :44: a microbatched step against the
    reference's microbatched step).

    The grad norm is held within STEP_RTOL, or NORM_FLOOR_X times the
    reference's own regrouping floor (``norm_floor``) where that is
    wider.  The port's matmuls and the reference's round otherwise (the
    two libraries' f32 kernels), and at the reduced config's random
    fan_in weights a gradient element's f32 rounding is amplified to
    ~1e-4 of its leaf's scale in both packages alike (each against the
    port's float64 gradient), so the norm, a sum over ~1e5 such
    squares, parts by more than either package's own regroupings move
    it.  Measured on an AMD EPYC host: the floor 6.3e-6 (jitted against
    op by op; one microbatch against two 1.5e-6), the port against the
    reference 1.35e-5 and 1.50e-5; elsewhere the two have agreed within
    1e-5 and the floor does not widen the bar."""
    run = RunConfig(optimizer=optimizer, learning_rate=5e-3,
                    microbatches=microbatches)
    (js, jb, rcfg), (ts, tb, cfg) = _step_pair(R, run)
    rstep = R.jax.jit(R.step.build_train_step(
        rcfg, R.base.RunConfig(**dataclasses.asdict(run)), total_steps=100))
    tstep = build_train_step(cfg, run, total_steps=100)
    for _ in range(2):
        js, jm = rstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            rtol = STEP_RTOL if k != "grad_norm" else \
                max(STEP_RTOL, NORM_FLOOR_X * norm_floor)
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=rtol, atol=1e-8, err_msg=k)
    want = _flat(R.jax.tree.map(np.asarray, js["params"]))
    for k, got in _flat(ts["params"]).items():
        _close_scaled(got, want[k], what=k)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["rng"].tolist() == [0, 2]


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw8bit"])
def test_optimizer_reduces_loss(name):
    """The twin of tests/test_substrate.py:33 on the port alone: 8 steps
    on one batch lower the loss (reduced llama, bf16)."""
    cfg = get_arch("llama3-8b").reduced()
    run = RunConfig(optimizer=name, learning_rate=5e-3)
    params = init_params(zoo.model_specs(cfg), torch.Generator().manual_seed(0),
                         cfg.dtype, device="cpu")
    state = init_state(cfg, run, params)
    batch = zoo.make_batch(cfg, CELL, 0, device="cpu")
    step = build_train_step(cfg, run, total_steps=100)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_microbatched_grads_match_full():
    """Gradient accumulation over microbatches equals the single-batch
    gradient (the twin of tests/test_substrate.py:44): the grad norm of
    a 4-microbatch step within 5e-3 of the full batch's, the same
    params after the step within 5e-3 of their scale."""
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="float32")
    batch = zoo.make_batch(cfg, CELL, 0, device="cpu")
    out = {}
    for mb in (1, 4):
        run = RunConfig(microbatches=mb, learning_rate=1e-3)
        params = init_params(zoo.model_specs(cfg),
                             torch.Generator().manual_seed(0), "float32",
                             device="cpu")
        state, m = build_train_step(cfg, run)(init_state(cfg, run, params),
                                              batch)
        out[mb] = (m, state["params"])
    np.testing.assert_allclose(float(out[4][0]["grad_norm"]),
                               float(out[1][0]["grad_norm"]), rtol=5e-3)
    for a, b in zip(optim.tree_leaves(out[4][1]),
                    optim.tree_leaves(out[1][1])):
        _close_scaled(a, b.detach(), rel=5e-3)


def test_step_rejects_sharding_arguments():
    """``dp_axes`` / ``grad_shardings`` run over a mesh with one card on
    its data axes (tests/test_torch_launch.py); a data axis over several
    distinct cards (GSPMD in the reference) is refused, and so are
    ``dp_axes`` with no mesh to name."""
    from repro_torch.sharding.logical import LogicalMesh, NamedSharding
    cfg = get_arch("llama3-8b").reduced()
    two = LogicalMesh(("data", "model"), (2, 1),
                      (torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(NotImplementedError, match="data axis"):
        build_train_step(cfg, RunConfig(), dp_axes=("data",), mesh=two)
    with pytest.raises(NotImplementedError, match="data axis"):
        build_train_step(cfg, RunConfig(),
                         grad_shardings={"w": NamedSharding(two, ("data",))})
    with pytest.raises(ValueError, match="mesh"):
        build_train_step(cfg, RunConfig(), dp_axes=("data",))


def test_step_rejects_a_model_axis_over_several_cards():
    """A model axis over several distinct devices in one process (tensor
    parallelism) is refused, naming its ROADMAP item; the same device
    named twice on it is one card and runs."""
    from repro_torch.sharding.logical import LogicalMesh
    cfg = get_arch("llama3-8b").reduced()
    two = LogicalMesh(("data", "model"), (1, 2),
                      (torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(NotImplementedError, match="model axis.*item 8"):
        build_train_step(cfg, RunConfig(), dp_axes=("data",), mesh=two)
    twice = LogicalMesh(("data", "model"), (1, 2), (torch.device("cpu"),) * 2)
    build_train_step(cfg, RunConfig(), dp_axes=("data",), mesh=twice)


def test_int8_step_replays_from_its_counter():
    """With grad_compression="int8" the step draws its uniforms from
    (seed, counter): two runs from equal states give bit-equal params,
    and rng advances by one a step."""
    cfg = get_arch("llama3-8b").reduced()
    run = RunConfig(grad_compression="int8", learning_rate=1e-3)
    batch = zoo.make_batch(cfg, CELL, 0, device="cpu")
    outs = []
    for _ in range(2):
        params = init_params(zoo.model_specs(cfg),
                             torch.Generator().manual_seed(0), cfg.dtype,
                             device="cpu")
        state = init_state(cfg, run, params)
        step = build_train_step(cfg, run)
        for _ in range(2):
            state, _ = step(state, batch)
        outs.append(state)
    assert outs[0]["rng"].tolist() == [0, 2]
    for a, b in zip(optim.tree_leaves(outs[0]["params"]),
                    optim.tree_leaves(outs[1]["params"])):
        assert torch.equal(a, b)


def test_global_norm():
    tree = {"a": torch.full((3,), 2.0), "b": {"c": torch.full((4,), 1.0,
                                                            dtype=torch.bfloat16)}}
    assert float(global_norm(tree)) == pytest.approx(4.0)


# ------------------------------------------------------------------ pipeline
def test_pipeline_batches_equal_reference(R):
    """_batch_for_step and _extra_inputs bit-equal to the reference's,
    sharded and not (the twin of tests/test_substrate.py:89)."""
    for step, shard in ((7, DataShard(0, 1)), (7, DataShard(0, 2)),
                        (7, DataShard(1, 2)), (123, DataShard(3, 4))):
        got = _batch_for_step(step, shard, 512, 8, 16)
        want = R.pipeline._batch_for_step(
            step, R.pipeline.DataShard(shard.shard_id, shard.n_shards),
            512, 8, 16)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    s0 = _batch_for_step(7, DataShard(0, 2), 512, 8, 16)
    s1 = _batch_for_step(7, DataShard(1, 2), 512, 8, 16)
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    for name in ("llava-next-34b", "seamless-m4t-large-v2"):
        got = _extra_inputs(get_arch(name).reduced(), CELL, 5, 1234)
        want = R.pipeline._extra_inputs(R.ARCHS[name].reduced(), CELL, 5,
                                        1234)
        assert sorted(got) == sorted(want) and got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_iterator_and_skip(R):
    """TokenPipeline yields the reference pipeline's batches as tensors
    on its device, from start_step and after skip_to (the twin of
    tests/test_substrate.py:100)."""
    cfg = get_arch("llava-next-34b").reduced()
    cell = ShapeCell("t", 16, 4, "train")
    pipe = TokenPipeline(cfg, cell, start_step=3, device="cpu")
    ref = R.pipeline.TokenPipeline(R.ARCHS["llava-next-34b"].reduced(),
                                   R.base.ShapeCell("t", 16, 4, "train"),
                                   start_step=3)
    try:
        for skip in (None, 10):
            if skip is not None:
                pipe.skip_to(skip)
                ref.skip_to(skip)
            got, want = next(pipe), next(ref)
            assert sorted(got) == sorted(want)
            for k in want:
                assert isinstance(got[k], torch.Tensor)
                assert got[k].device == torch.device("cpu")
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert pipe.step == 11
    finally:
        pipe.close()
        ref.close()


# --------------------------------------------------------------- checkpoints
def _bf16_state(R, run=RunConfig()):
    """A reduced llama's train state in both packages (bf16 params, the
    reference's own values)."""
    rcfg = R.ARCHS["llama3-8b"].reduced()
    cfg = get_arch("llama3-8b").reduced()
    rp = R.init(R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(0), rcfg.dtype)
    tp = _port_params(R, rp)
    return (R.step.init_state(rcfg, R.base.RunConfig(), rp),
            init_state(cfg, run, tp))


def test_checkpoint_roundtrip_and_gc(R):
    """Five saves keep two; restore gives the state back bit for bit, on
    the template's devices and in its dtypes (bf16 params widened to f32
    on disk and narrowed back; the twin of tests/test_substrate.py:114)."""
    _, state = _bf16_state(R)
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(state, d, s, keep=2)
        assert ckpt.latest_step(d) == 5
        kept = sorted(os.listdir(d))
        assert len([k for k in kept if k.startswith("step_")]) == 2
        path = os.path.join(d, "step_00000005")
        assert os.path.exists(os.path.join(path, "manifest.json"))
        assert np.load(os.path.join(
            path, "params__layers__attn__wq.npy")).dtype == np.float32
        restored, step = ckpt.restore(state, d)
        assert step == 5
        a_flat, b_flat = _flat(restored), _flat(state)
        assert sorted(a_flat) == sorted(b_flat)
        for k, b in b_flat.items():
            a = a_flat[k]
            assert a.dtype == b.dtype and a.device == b.device, k
            assert torch.equal(a, b.detach()), k


def test_reference_checkpoint_restores_in_port_and_back(R):
    """A checkpoint the reference writes restores into the port's state
    (same files, same keys), and one the port writes restores into the
    reference's, every leaf equal."""
    jstate, tstate = _bf16_state(R)
    with tempfile.TemporaryDirectory() as d:
        R.ckpt.save(jstate, d, 3)
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            import json
            keys = json.load(f)["keys"]
        assert keys == sorted(_flat(tstate))
        restored, step = ckpt.restore(tstate, d)
        assert step == 3
        want = _flat(R.jax.tree.map(np.asarray, jstate))
        for k, got in _flat(restored).items():
            np.testing.assert_array_equal(
                _np(got), np.asarray(want[k]).astype(_np(got).dtype), k)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(tstate, d, 4)
        back, step = R.ckpt.restore(jstate, d)
        assert step == 4
        want = _flat(tstate)
        for k, got in _flat(R.jax.tree.map(np.asarray, back)).items():
            if k == "rng":
                continue            # a PRNG key in one, (seed, counter) here
            np.testing.assert_array_equal(np.asarray(got, np.float64),
                                          _np(want[k]).astype(np.float64), k)


def test_async_checkpointer_snapshots_before_returning():
    """maybe_save copies the state to the host before it returns: an
    in-place update right after does not reach the checkpoint."""
    state = {"w": torch.arange(6.0), "step": torch.tensor(1)}
    with tempfile.TemporaryDirectory() as d:
        saver = ckpt.AsyncCheckpointer(d, keep=2)
        assert saver.maybe_save(state, 1)
        state["w"].add_(100.0)
        saver.wait()
        restored, _ = ckpt.restore(state, d)
        assert torch.equal(restored["w"], torch.arange(6.0))
        assert saver.last_saved == 1


# --------------------------------------------------------------- fault loop
def _loop_setup(seed=0):
    cfg = get_arch("llama3-8b").reduced()
    run = RunConfig(learning_rate=1e-3)
    params = init_params(zoo.model_specs(cfg),
                         torch.Generator().manual_seed(seed), cfg.dtype,
                         device="cpu")
    pipe_batches = lambda s: {k: torch.from_numpy(v) for k, v in
                              _batch_for_step(s, DataShard(0, 1), cfg.vocab,
                                              CELL.global_batch,
                                              CELL.seq_len).items()}
    return (build_train_step(cfg, run, total_steps=100),
            init_state(cfg, run, params), pipe_batches)


def test_fault_tolerant_loop_restarts():
    """Two injected failures: two restarts, the loop ends at step 16
    (the twin of tests/test_substrate.py:139)."""
    step, state, batches = _loop_setup()
    with tempfile.TemporaryDirectory() as d:
        fc = FaultConfig(ckpt_dir=d, ckpt_every=4, max_restarts=3,
                         inject_failures_at=(6, 11))
        state2, stats = run_training(step, state, batches, 16, fc)
        assert stats.restarts == 2
        assert int(state2["step"]) == 16
        assert stats.steps_run >= 16
        assert ckpt.latest_step(d) == 16


def test_restart_replays_uninterrupted_run_bit_for_bit():
    """A run with a failure at step 6 (restored from step 4) ends with
    the parameters and optimizer state of an uninterrupted run, bit for
    bit, and its replayed steps 4-5 repeat their losses exactly."""
    out = {}
    for fails in ((), (6,)):
        step, state, batches = _loop_setup()
        with tempfile.TemporaryDirectory() as d:
            fc = FaultConfig(ckpt_dir=d, ckpt_every=4,
                             inject_failures_at=fails)
            out[fails] = run_training(step, state, batches, 10, fc)
    (a, sa), (b, sb) = out[()], out[(6,)]
    assert (sa.restarts, sb.restarts) == (0, 1)
    assert sb.losses == sa.losses[:6] + sa.losses[4:]
    for x, y in zip(optim.tree_leaves({k: a[k] for k in ("params", "opt")}),
                    optim.tree_leaves({k: b[k] for k in ("params", "opt")})):
        assert torch.equal(x, y)
    assert a["rng"].tolist() == b["rng"].tolist() == [0, 10]


# ---------------------------------------------------------------- on a card
@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device: the flash kernel has no CPU "
                           "mode")
def test_flash_grads_and_train_step_on_card():
    """On the card: layers.flash_attention's q/k/v gradients against
    autograd through plain_attention (f32 within 2e-3 of the largest
    gradient, bf16 within 2**-6); ops.flash_attention raising for a
    CUDA operand that requires grad; and a reduced f32 train step on the
    card against the CPU port's step from the same parameters."""
    for dtype, rel in ((torch.float32, 2e-3), (torch.bfloat16, 2 ** -6)):
        cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                                  dtype="float32", attn_impl="chunked",
                                  attn_chunk=128)
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(2, 300, h, 64, generator=g, device="cuda")
                   .to(dtype).requires_grad_(True) for h in (8, 2, 2))
        go = torch.randn(2, 300, 8, 64, generator=g, device="cuda").to(dtype)
        plain = functools.partial(transformer.plain_attention, cfg=cfg)
        got = torch.autograd.grad(layers.flash_attention(q, k, v, plain),
                                  (q, k, v), go)
        want = torch.autograd.grad(plain(q, k, v), (q, k, v), go)
        for a, b in zip(got, want):
            _close_scaled(a.cpu(), b.float().cpu().numpy(), rel=rel)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous())
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="float32", remat="selective")
    run = RunConfig(learning_rate=1e-3, microbatches=2)
    out = {}
    for dev in ("cpu", "cuda"):
        params = init_params(zoo.model_specs(cfg),
                             torch.Generator().manual_seed(0), "float32",
                             device="cpu")
        params = optim.tree_map(lambda p: p.to(dev), params)
        batch = zoo.make_batch(cfg, CELL, 0, device=dev)
        state, m = build_train_step(cfg, run)(init_state(cfg, run, params),
                                              batch)
        out[dev] = (m, state)
    np.testing.assert_allclose(float(out["cuda"][0]["loss"]),
                               float(out["cpu"][0]["loss"]), rtol=1e-4)
    for a, b in zip(optim.tree_leaves(out["cuda"][1]["params"]),
                    optim.tree_leaves(out["cpu"][1]["params"])):
        _close_scaled(a.cpu(), b.detach().numpy(), rel=SCALED)
