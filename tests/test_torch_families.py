"""The port's five non-dense LM families against the reference's, on the
CPU.

Every input is made with numpy from a seed and handed to both packages.
Whole models are the six configurations of the moe (mixtral-8x7b,
kimi-k2), ssm (mamba2-780m), hybrid (zamba2-2.7b), vlm (llava-next-34b)
and encdec (seamless-m4t-large) families, ``reduced()`` in float32, with
the reference's own randomly initialised parameters carried across by
``params_from_reference``: forward logits, prefill logits and every
cache entry, and three decode steps, within ``SCALED`` of the compared
tensor's largest magnitude (``tests/test_torch_models.py``'s
``_close_scaled``).  Unit twins hold the MoE dispatch with capacity
drops, the chunked SSD scan at a ragged length, the sliding-window ring
decode past the window, windowed and offset attention, the vlm prefix
and the encdec cross-attention.  The one ``gpu`` test holds the CUDA
flash kernel to its plain version at the shapes these families give it;
the reference is imported inside a fixture, so that test also runs where
JAX is absent.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import ARCHS, cells, get_arch
from repro_torch.convert import params_from_reference
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import encdec, layers, mamba2, moe, transformer, zoo
from repro_torch.models.params import ParamSpec, init_params

FAMILIES = sorted(n for n, c in ARCHS.items() if c.family != "dense")
B, S, SRC = 2, 48, 40           # batch, prompt tokens, encdec source frames
STEPS = 3                       # decode steps compared
# as tests/test_torch_models.py: max |diff| within this fraction of the
# compared tensor's largest magnitude (the reference's fan_in rule makes
# hidden states ~100 at random weights; f32 summation order differs)
SCALED = 2e-3


@pytest.fixture(scope="module")
def R():
    """jax, jax.numpy and the reference's modules."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import base, registry
    from repro.models import encdec as ed
    from repro.models import layers, mamba2, moe, params, transformer, zoo
    return SimpleNamespace(jax=jax, jnp=jnp, base=base, registry=registry,
                           ARCHS=registry.ARCHS, ed=ed, layers=layers,
                           mamba=mamba2, moe=moe, zoo=zoo,
                           init=params.init_params,
                           forward=transformer.forward_seq,
                           unembed=transformer._unembed)


def _close_scaled(got, want, rel=SCALED):
    got = got.float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reduced(R, name):
    return dataclasses.replace(R.ARCHS[name].reduced(), dtype="float32")


def _batch(cfg, rng):
    """Prompt tokens (B, S), plus the vlm's prefix embeddings or the
    encdec's source frames, N(0, 0.02) as ``make_batch`` draws them."""
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(
            0, 0.02, (B, SRC, cfg.d_model)).astype(np.float32)
    out["next"] = rng.integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def fams(R):
    """Per family arch: (reference config, reference params, port
    config, port params converted from the reference's, batch)."""
    out = {}
    rng = np.random.default_rng(11)
    for name in FAMILIES:
        rcfg = _reduced(R, name)
        rp = R.init(R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(0),
                      rcfg.dtype)
        cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
        tp = params_from_reference(R.jax.tree.map(np.asarray, rp),
                                   device="cpu")
        out[name] = (rcfg, rp, cfg, tp, _batch(cfg, rng))
    return out


def _split(R, batch):
    """The prefill batch for each package (numpy -> jnp / torch)."""
    keys = [k for k in batch if k != "next"]
    return ({k: R.jnp.asarray(batch[k]) for k in keys},
            {k: _t(batch[k]) for k in keys})


def _cache_len(cfg):
    """Room for the prompt (and a vlm's prefix) and 8 more positions."""
    return S + cfg.n_prefix_embeds + 8


def _cache_equal(ct, cj):
    assert sorted(ct) == sorted(cj)
    for name in cj:
        if name == "pos":
            assert ct["pos"] == int(cj["pos"])
        else:
            assert ct[name].dtype == torch.float32
            _close_scaled(ct[name], cj[name])


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(R, fams, name):
    """Full-sequence logits on the same parameters and batch: forward_seq
    + _unembed (the vlm with its prefix), or for encdec the encoder
    memory and the teacher-forced decoder."""
    rcfg, rp, cfg, tp, batch = fams[name]
    bj, bt = _split(R, batch)
    if cfg.family == "encdec":
        mj = R.ed.encode(rp, bj["src_embeds"], rcfg)
        mt = encdec.encode(tp, bt["src_embeds"], cfg)
        _close_scaled(mt, mj)
        _close_scaled(encdec.decode_train(tp, mt, bt["tokens"], cfg),
                      R.ed.decode_train(rp, mj, bj["tokens"], rcfg))
        return
    x, aux_j, _ = R.forward(rp, bj["tokens"], rcfg,
                              bj.get("prefix_embeds"))
    xt, aux_t, _ = transformer.forward_seq(tp, bt["tokens"], cfg,
                                           bt.get("prefix_embeds"))
    _close_scaled(transformer._unembed(tp, xt, cfg),
                  R.unembed(rp, x, rcfg))
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_cache_match_reference(R, fams, name):
    """Prefill's last-position logits and every cache entry (k/v rings,
    conv and ssm state, hybrid k/v, encdec memory k/v, pos)."""
    rcfg, rp, cfg, tp, batch = fams[name]
    bj, bt = _split(R, batch)
    cache_len = _cache_len(cfg)
    lj, cj = R.jax.jit(R.zoo.prefill_fn(rcfg, cache_len))(rp, bj)
    lt, ct = zoo.prefill_fn(cfg, cache_len)(tp, bt)
    assert lt.shape == (B, 1, cfg.vocab) and lt.dtype == torch.float32
    _close_scaled(lt, lj)
    _cache_equal(ct, cj)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_match_reference(R, fams, name):
    """Three decode steps after prefill, each step's logits and the
    caches after the last (mixtral: slots past the 32-slot window)."""
    rcfg, rp, cfg, tp, batch = fams[name]
    bj, bt = _split(R, batch)
    cache_len = _cache_len(cfg)
    _, cj = R.jax.jit(R.zoo.prefill_fn(rcfg, cache_len))(rp, bj)
    _, ct = zoo.prefill_fn(cfg, cache_len)(tp, bt)
    step_j = R.jax.jit(R.zoo.decode_fn(rcfg))
    step_t = zoo.decode_fn(cfg)
    for i in range(STEPS):
        dj, cj = step_j(rp, R.jnp.asarray(batch["next"][:, i]), cj)
        dt, ct = step_t(tp, _t(batch["next"][:, i]), ct)
        _close_scaled(dt, dj)
    _cache_equal(ct, cj)


# ---------------------------------------------------------------------- moe
def _moe_case(R, cf, n_experts=4, top_k=2, t=64, seed=0):
    rcfg = dataclasses.replace(
        R.ARCHS["mixtral-8x7b"].reduced(), dtype="float32",
        moe=R.base.MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=16,
                         capacity_factor=cf, n_shared_experts=1))
    cfg = dataclasses.replace(
        get_arch("mixtral-8x7b").reduced(), dtype="float32",
        moe=MoEConfig(n_experts=n_experts, top_k=top_k, d_expert=16,
                      capacity_factor=cf, n_shared_experts=1))
    rp = R.init(R.moe.moe_specs(rcfg), R.jax.random.PRNGKey(seed),
                  "float32")
    rp = dict(rp, router=rp["router"] * 20.0)
    tp = params_from_reference(R.jax.tree.map(np.asarray, rp), device="cpu")
    # a direction common to every token skews the routing, so the busiest
    # experts overflow their capacity
    x = _normal((2, t // 2, cfg.d_model), seed + 1) + \
        2.0 * _normal((cfg.d_model,), seed + 2)
    return rcfg, rp, cfg, tp, x


@pytest.mark.parametrize("cf,seed", [(0.5, 0), (1.25, 0), (1.25, 12)])
def test_moe_dispatch_with_drops_matches_reference(R, cf, seed):
    """capacity_factor 0.5 (E * cap < a: dropped assignments fall off
    the slot table) and 1.25 (E * cap > a: a dropped assignment's write
    lands on slot a, as in the reference; with seed 12 the last expert
    overflows, its drops are written after slot a's kept token, and the
    slot ends empty in both packages): tok_of_slot, gate_of_slot and
    the occupied mask and the gathered rows equal the reference's
    exactly, gate_of_slot within 1e-6 (two softmax implementations in
    f32); y within 1e-5 of its largest magnitude (the expert products
    and gated sums round in another order), load_balance and router_z
    within rtol = atol = 1e-5."""
    rcfg, rp, cfg, tp, x = _moe_case(R, cf, seed=seed)
    t = x.shape[0] * x.shape[1]
    m = cfg.moe
    a = t * m.top_k
    cap = int(max(min(t, 16), round(a / m.n_experts * cf)))
    xf = x.reshape(t, -1)
    logits = xf @ np.asarray(rp["router"])
    want = R.moe._dispatch_one_group(R.jnp.asarray(xf), R.jnp.asarray(logits),
                                       rcfg.moe, cap)
    got = moe._dispatch_one_group(_t(xf), _t(logits), m, cap)
    drops = a - int(np.asarray(want[3]).sum())
    assert drops > 0
    if seed == 12:
        assert a < m.n_experts * cap and int(want[1][a]) == -1
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    yj, auxj = R.moe.moe_ffn(rp, R.jnp.asarray(x), rcfg)
    yt, auxt = moe.moe_ffn(tp, _t(x), cfg)
    _close_scaled(yt, yj, rel=1e-5)
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, atol=1e-5)


def test_moe_dropped_tokens_contribute_nothing(R):
    """Capacity 16 per expert for 64 top-1 tokens on 2 experts (the
    reference's test_moe_capacity_drops): at least 32 rows of y are
    dropped by both experts, so they carry only the shared expert's
    output, equal to the shared SwiGLU on those rows."""
    rcfg, rp, cfg, tp, x = _moe_case(R, 0.01, n_experts=2, top_k=1, t=64,
                                     seed=3)
    yt, _ = moe.moe_ffn(tp, _t(x), cfg)
    xf = _t(x).reshape(64, -1)
    shared = (torch.nn.functional.silu(xf @ tp["ws1"]) * (xf @ tp["ws3"])) \
        @ tp["ws2"]
    only_shared = torch.isclose(yt.reshape(64, -1), shared, rtol=1e-6,
                                atol=1e-6).all(dim=-1)
    assert int(only_shared.sum()) >= 64 - 2 * 16


# ---------------------------------------------------------------------- ssd
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_ragged_matches_reference_and_recurrence(R, with_state):
    """S = 40 with chunk 16 (a ragged last chunk of 8, padded with
    zero-dt identity steps), G = 2 groups over 4 heads, with and without
    an initial state: y and the final state against the reference's
    ssd_chunked (rtol = atol = 1e-5) and against the step-by-step
    recurrence in f64 (rtol = atol = 2e-3, the reference's
    test_ssd_chunked_matches_recurrence)."""
    rng = np.random.default_rng(1)
    b, s, h, p, n, g = 2, 40, 4, 8, 16, 2
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    a_neg = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if with_state \
        else None
    yj, fj = R.mamba.ssd_chunked(
        *map(R.jnp.asarray, (x, dt, a_neg, bm, cm)), chunk=16,
        init_state=None if s0 is None else R.jnp.asarray(s0))
    yt, ft = mamba2.ssd_chunked(*map(_t, (x, dt, a_neg, bm, cm)), chunk=16,
                                init_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5,
                               atol=1e-5)
    state = np.zeros((b, h, p, n)) if s0 is None else s0.astype(np.float64)
    ys = np.zeros((b, s, h, p))
    bn = np.repeat(bm.astype(np.float64), h // g, axis=2)
    cn = np.repeat(cm.astype(np.float64), h // g, axis=2)
    for i in range(s):
        decay = np.exp(dt[:, i].astype(np.float64) * a_neg)[:, :, None, None]
        xt = x[:, i] * dt[:, i][..., None].astype(np.float64)
        state = state * decay + xt[..., None] * bn[:, i][:, :, None, :]
        ys[:, i] = np.einsum("bhpn,bhn->bhp", state, cn[:, i])
    np.testing.assert_allclose(yt.numpy(), ys, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ft.numpy(), state, rtol=2e-3, atol=2e-3)


def test_mamba_prefill_then_decode_matches_forward(fams):
    """mamba2 reduced: prefill of tokens[:, :-1] then one decode step
    give forward_seq's logits at -2 and -1 (the reference's serving
    contract, rtol = atol = 2e-3 and 5e-3), at S = 48 (three chunks of
    16) and S = 45 (a ragged last chunk in prefill)."""
    _, _, cfg, tp, batch = fams["mamba2-780m"]
    for s in (48, 45):
        t = _t(batch["tokens"][:, :s])
        x, _, _ = transformer.forward_seq(tp, t, cfg)
        full = transformer._unembed(tp, x, cfg)
        lp, cache = zoo.prefill_fn(cfg, s + 8)(tp, {"tokens": t[:, :-1]})
        np.testing.assert_allclose(lp[:, 0].numpy(), full[:, -2].numpy(),
                                   rtol=2e-3, atol=2e-3)
        ld, _ = zoo.decode_fn(cfg)(tp, t[:, -1], cache)
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, -1].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------- attention
def test_swa_ring_buffer_decode(R, fams):
    """The reference's test_swa_ring_buffer_decode: mixtral reduced
    (window 32), s = 60: prefill of 59 tokens rolls the last 32 into the
    ring, and one decode step (slot 59 % 32) equals the forward's last
    logits (rtol = atol = 5e-3), on the port and against the reference's
    decode (SCALED)."""
    rcfg, rp, cfg, tp, _ = fams["mixtral-8x7b"]
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (B, 60)).astype(np.int32)
    x, _, _ = transformer.forward_seq(tp, _t(tokens), cfg)
    full = transformer._unembed(tp, x, cfg)
    lp, cache = zoo.prefill_fn(cfg, 68)(tp, {"tokens": _t(tokens[:, :-1])})
    assert cache["k"].shape[2] == 32 and cache["pos"] == 59
    ld, cache = zoo.decode_fn(cfg)(tp, _t(tokens[:, -1]), cache)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)
    _, cj = R.jax.jit(R.zoo.prefill_fn(rcfg, 68))(
        rp, {"tokens": R.jnp.asarray(tokens[:, :-1])})
    dj, cj = R.jax.jit(R.zoo.decode_fn(rcfg))(rp, R.jnp.asarray(tokens[:, -1]),
                                              cj)
    _close_scaled(ld, dj)
    _close_scaled(cache["k"], cj["k"])


@pytest.mark.parametrize("pos", [31, 32, 45, 70])
def test_ring_decode_attention_matches_reference(R, pos):
    """decode_attention's ring mask (cache of 32 slots, window 32)
    before, at and past the wrap, against the reference: f32, 2e-5."""
    q = _normal((2, 1, 8, 32), 0)
    k, v = _normal((2, 32, 2, 32), 1), _normal((2, 32, 2, 32), 2)
    want = R.layers.decode_attention(*map(R.jnp.asarray, (q, k, v)),
                                       R.jnp.int32(pos), window=32)
    got = layers.decode_attention(*map(_t, (q, k, v)), pos, window=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("q0,window", [(0, 24), (16, 24), (40, None),
                                       (40, 7)])
def test_windowed_attention_matches_reference(R, q0, window):
    """dense_attention and chunked_attention with a query offset ``q0``
    and a sliding window against the reference's (f32, 2e-5; the chunked
    path at chunks of 32 over 80 queries and 120 keys), and
    flash_attention_ref (and ops.flash_attention's CPU lane) with the
    window against the reference's dense_attention at q0 = 0 (2e-5)."""
    q = _normal((2, 80, 8, 32), 3)
    k, v = _normal((2, 120, 2, 32), 4), _normal((2, 120, 2, 32), 5)
    qj, kj, vj = map(R.jnp.asarray, (q, k, v))
    qt, kt, vt = map(_t, (q, k, v))
    want = R.layers.dense_attention(qj, kj, vj, q0=q0, causal=True,
                                      window=window)
    got = layers.dense_attention(qt, kt, vt, q0=q0, causal=True,
                                 window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    want_c = R.layers.chunked_attention(qj, kj, vj, q0=q0, causal=True,
                                          window=window, chunk_q=32,
                                          chunk_k=32)
    got_c = layers.chunked_attention(qt, kt, vt, q0=q0, causal=True,
                                     window=window, chunk_q=32, chunk_k=32)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=2e-5, atol=2e-5)
    if q0 == 0:
        got_f = flash_attention_ref(qt.transpose(1, 2), kt.transpose(1, 2),
                                    vt.transpose(1, 2), causal=True,
                                    window=window).transpose(1, 2)
        np.testing.assert_allclose(got_f.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
        got_o = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                    vt.transpose(1, 2), causal=True,
                                    window=window).transpose(1, 2)
        np.testing.assert_allclose(got_o.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_flash_window_skips_nothing_visible():
    """flash_attention_ref with a window equal to or longer than the
    sequence is the unwindowed function; window 1 leaves each row its
    own key, so the output is v at that row's position."""
    q = _t(_normal((1, 4, 256, 16), 6))
    k, v = _t(_normal((1, 2, 256, 16), 7)), _t(_normal((1, 2, 256, 16), 8))
    base = flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(flash_attention_ref(q, k, v, causal=True,
                                           window=256), base)
    one = flash_attention_ref(q, k, v, causal=True, window=1)
    torch.testing.assert_close(one, v.repeat_interleave(2, 1), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, window=0)


# ----------------------------------------------------------- vlm and encdec
def test_vlm_prefix_matches_reference(R, fams):
    """llava reduced: the 8 prefix embeddings come before the tokens in
    the port as in the reference (forward_seq hidden states, SCALED),
    prefill's cache holds prefix + tokens positions, and its last logits
    equal the forward's last position (rtol = atol = 2e-3)."""
    rcfg, rp, cfg, tp, batch = fams["llava-next-34b"]
    bj, bt = _split(R, batch)
    x, _, _ = R.forward(rp, bj["tokens"], rcfg, bj["prefix_embeds"])
    xt, _, (k, _) = transformer.forward_seq(tp, bt["tokens"], cfg,
                                            bt["prefix_embeds"],
                                            collect_cache=True)
    assert xt.shape == (B, cfg.n_prefix_embeds + S, cfg.d_model)
    assert k.shape[2] == cfg.n_prefix_embeds + S
    _close_scaled(xt, x)
    lp, cache = zoo.prefill_fn(cfg, 64)(tp, bt)
    assert cache["pos"] == cfg.n_prefix_embeds + S
    full = transformer._unembed(tp, xt, cfg)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)
    # the prefix matters: zero embeddings give other logits
    lz, _ = zoo.prefill_fn(cfg, 64)(
        tp, dict(bt, prefix_embeds=torch.zeros_like(bt["prefix_embeds"])))
    assert not torch.allclose(lz, lp)


@pytest.mark.parametrize("attn_impl,chunk", [("dense", 64), ("chunked", 8)])
def test_encdec_cross_attention_matches_reference(R, fams, attn_impl,
                                                 chunk):
    """seamless reduced: one decoder layer's cross-attention (no RoPE,
    non-causal, 48 queries against 40 memory frames) and the encoder's
    bidirectional self-attention through ``_attend``, dense and chunked
    (chunks of 8 divide both lengths), against the reference's (f32,
    SCALED)."""
    rcfg, rp, cfg, tp, batch = fams["seamless-m4t-large-v2"]
    rcfg = dataclasses.replace(rcfg, attn_impl=attn_impl, attn_chunk=chunk)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl, attn_chunk=chunk)
    xq = _normal((B, S, cfg.d_model), 12)
    mem = _normal((B, SRC, cfg.d_model), 13)
    pj = R.jax.tree.map(lambda a: a[0], rp["dec_layers"]["cross"])
    pt = transformer.layer_params(tp["dec_layers"], 0)["cross"]
    want, (kj, _) = R.ed._attend(pj, R.jnp.asarray(xq), R.jnp.asarray(mem),
                                   rcfg, None, None, None, None,
                                   causal=False, rope=False)
    got, (kt, _) = encdec._attend(pt, _t(xq), _t(mem), cfg, None, None, None,
                                  None, causal=False, rope=False)
    _close_scaled(got, want)
    _close_scaled(kt, kj)
    rot = int(cfg.hd * cfg.partial_rotary)
    cj, sj = R.layers.rope_tables(R.jnp.arange(SRC), rot, cfg.rope_theta)
    ct, st = layers.rope_tables(torch.arange(SRC), rot, cfg.rope_theta)
    pe = R.jax.tree.map(lambda a: a[0], rp["enc_layers"]["attn"])
    want_e, _ = R.ed._attend(pe, R.jnp.asarray(mem), R.jnp.asarray(mem), rcfg,
                               cj, sj, cj, sj, causal=False)
    got_e, _ = encdec._attend(
        transformer.layer_params(tp["enc_layers"], 0)["attn"], _t(mem),
        _t(mem), cfg, ct, st, ct, st, causal=False)
    _close_scaled(got_e, want_e)


# ------------------------------------------------- configs, batches, params
def test_cells_equal_reference(R):
    """cells() lists the reference's (arch, shape, skipped) grid, and
    long_context_ok admits the ssm, hybrid and sliding-window archs."""
    assert cells() == R.registry.cells()
    assert cells(include_skipped=True) == \
        R.registry.cells(include_skipped=True)
    assert {n for n, s, _ in cells() if s == "long_500k"} == {
        "mamba2-780m", "zamba2-2.7b", "mixtral-8x7b"}


@pytest.mark.parametrize("name", ["llava-next-34b", "seamless-m4t-large-v2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_batches_equal_reference(R, name, dtype):
    """make_batch draws the reference's vlm prefix / encdec source
    frames and tokens for the same seed: the tokens equal, the float
    entries equal in f32 and in bf16 (both round the f64 draw)."""
    for cell in (ShapeCell("p", 64, 2, "prefill"),
                 ShapeCell("d", 64, 2, "decode")):
        cfg = dataclasses.replace(get_arch(name).reduced(), dtype=dtype)
        rcfg = dataclasses.replace(R.ARCHS[name].reduced(), dtype=dtype)
        got = zoo.make_batch(cfg, cell, seed=5, device="cpu")
        want = R.zoo.make_batch(rcfg, cell, 5)
        assert sorted(got) == sorted(want)
        assert zoo.batch_desc(cfg, cell) == R.zoo.batch_desc(rcfg, cell)
        for k in got:
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(want[k], np.float32))
    assert zoo.cache_desc(get_arch(name), ShapeCell("d", 512, 3, "decode")) \
        == R.zoo.cache_desc(R.ARCHS[name], ShapeCell("d", 512, 3,
                                                         "decode"))


def test_init_params_draws_matrices():
    """init_params draws a stacked expert leaf one (d, f) matrix at a
    time: its values are the draw of each matrix in turn from the
    generator; a dense leaf keeps the one-layer-at-a-time draw, and an
    unstacked leaf one draw."""
    specs = {"we1": ParamSpec((2, 3, 8, 4), ("layers", "experts", "embed",
                                             "expert_mlp")),
             "wq": ParamSpec((2, 8, 2, 4), ("layers", "embed", "heads",
                                            "qkv")),
             "w": ParamSpec((8, 2, 4), ("embed", "heads", "qkv"))}
    got = init_params(specs, torch.Generator().manual_seed(7), "float32",
                      device="cpu")
    g = torch.Generator().manual_seed(7)
    we1 = torch.stack([torch.randn(8, 4, generator=g) for _ in range(6)])
    wq = torch.stack([torch.randn(8, 2, 4, generator=g) for _ in range(2)])
    w = torch.randn(8, 2, 4, generator=g)
    assert torch.equal(got["we1"],
                       (we1 * (1.0 / np.sqrt(8))).reshape(2, 3, 8, 4))
    assert torch.equal(got["wq"], wq * (1.0 / np.sqrt(2)))
    assert torch.equal(got["w"], w * (1.0 / np.sqrt(2)))


@pytest.mark.parametrize("name", FAMILIES)
def test_param_trees_equal_reference(R, fams, name):
    """The port's specs give the reference's tree (leaf paths, shapes)
    and ``params_from_reference`` casts to bf16 all but the leaves the
    specs pin to f32."""
    rcfg, rp, cfg, tp, _ = fams[name]
    specs = zoo.model_specs(cfg)

    def walk(spec, ref, conv, path=""):
        if isinstance(spec, ParamSpec):
            assert tuple(spec.shape) == ref.shape, path
            want = torch.float32 if spec.dtype == "float32" \
                else torch.bfloat16
            assert conv.dtype == want, path
            return
        assert sorted(spec) == sorted(ref), path
        for k in spec:
            walk(spec[k], ref[k], conv[k], f"{path}/{k}")

    bf = params_from_reference(R.jax.tree.map(np.asarray, rp), device="cpu",
                               dtype=torch.bfloat16, specs=specs)
    walk(specs, rp, bf)


# ---------------------------------------------------------------- the card
FAMILY_FLASH = [
    # (B, Hq, Hk, Sq, Sk, D, causal, window): zamba2's head width 80,
    # kimi-k2's 112 (GQA 64/8), mixtral's window past a tile boundary and
    # longer than some rows' history, seamless's non-causal encoder and
    # its cross-attention with Sq != Sk
    (2, 8, 8, 300, 300, 80, True, None),
    (1, 16, 2, 400, 400, 112, True, None),
    (1, 8, 2, 700, 700, 128, True, 300),
    (1, 8, 2, 700, 700, 64, True, 129),
    (1, 4, 4, 500, 500, 80, True, 200),
    (2, 8, 8, 300, 300, 64, False, None),
    (2, 8, 8, 1, 300, 64, False, None),
    (1, 4, 2, 200, 330, 112, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_FLASH)
def test_family_flash_shapes_match_plain_on_card(case, dtype):
    """The CUDA flash_attention kernel against flash_attention_ref on the
    same card inputs through ops.flash_attention (padding, kv_len,
    window): f32 within 1e-4 absolute, bf16 within one bf16 ulp (rtol =
    atol = 2**-7), as tests/test_torch_kernels.py holds the dense
    shapes; one counted launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, hq, hk, sq, sk, d, causal, window = case
    dev = torch.device("cuda")
    q, k, v = (_t(_normal(s, seed)).to(dev, dtype) for s, seed in
               (((b, hq, sq, d), 7), ((b, hk, sk, d), 8),
                ((b, hk, sk, d), 9)))
    _cuda.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == 1
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0
                               if dtype == torch.float32 else tol, atol=tol)
