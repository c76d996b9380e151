"""The port's dense-LM serving path against the reference's, on the CPU.

Every input is made with numpy from a seed and handed to both packages.
The reference runs ``repro.kernels.ops.flash_attention`` through its
Pallas kernel in interpret mode and its models as jitted jnp; the port
runs ``repro_torch`` on CPU tensors, where ``ops.flash_attention`` is
the kernel's plain version and the model's attention is
``dense_attention`` / ``chunked_attention`` as in the reference.  Whole
models are the four dense configurations, ``reduced()`` in float32, with
the reference's own randomly initialised parameters carried across by
``params_from_reference``.  The retrieval twin at the end is a reduced
``examples/retrieval_serving.py``: an encoder LM's embeddings, indexed
by LIMS, queried by exact kNN.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefConfig
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.kernels import ref as ref_kernel_ref
from repro.models import layers as ref_layers
from repro.models import zoo as ref_zoo
from repro.models.params import init_params as ref_init
from repro.models.transformer import _unembed as ref_unembed
from repro.models.transformer import forward_seq as ref_forward
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.convert import params_from_reference
from repro_torch.core import LIMSIndex, MetricSpace
from repro_torch.core.batched import BatchedLIMS
from repro_torch.core.metrics import dist_one_to_many
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import layers, transformer, zoo
from repro_torch.models.params import count_params, init_params

DENSE = sorted(ARCHS)


@pytest.fixture
def ref_ops(monkeypatch):
    """The reference's kernel wrappers, run through its Pallas kernels
    in interpret mode."""
    monkeypatch.setenv("REPRO_INTERPRET", "on")
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    from repro.kernels import ops as ref_kernel_ops
    return ref_kernel_ops


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _pair(a, dtype):
    """The same values for both packages: f32 numpy rounded to ``dtype``
    (round to nearest even on both sides)."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32), t


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# -------------------------------------------------------- flash attention
# the shapes of tests/test_kernels.py:130-135, plus a causal Sq != Sk case
FLASH_SHAPES = [
    (2, 8, 2, 256, 256, 64, True),
    (1, 4, 4, 100, 100, 32, True),
    (2, 8, 4, 128, 384, 64, False),
    (1, 2, 1, 64, 300, 16, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hk,sq,sk,d,causal", FLASH_SHAPES)
def test_flash_attention_matches_reference(ref_ops, dtype, b, hq, hk, sq,
                                           sk, d, causal):
    """The port's ops.flash_attention (plain lane) against the Pallas
    kernel in interpret mode: 2e-3 in f32, 3e-2 in bf16 (the reference's
    own kernel-vs-oracle tolerances, test_kernels.py:144)."""
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(_normal(s, seed), dtype) for s, seed in
        (((b, hq, sq, d), 7), ((b, hk, sk, d), 8), ((b, hk, sk, d), 9)))
    want = ref_ops.flash_attention(qj, kj, vj, causal=causal)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == dtype and got.shape == (b, hq, sq, d)
    tol = 2e-3 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100)])
def test_flash_attention_causal_origin_is_top_left(ref_ops, sq, sk):
    """Causal with Sq != Sk: query row i sees keys 0..i (the kernel's
    mask, flash_attention.py:50-52), not attention_ref's bottom-right
    alignment.  Pinned against the reference kernel and on row 0, which
    sees key 0 only, so its output is v[key 0]."""
    b, hq, hk, d = 1, 4, 2, 32
    q, k, v = (_normal(s, seed) for s, seed in
               (((b, hq, sq, d), 1), ((b, hk, sk, d), 2), ((b, hk, sk, d), 3)))
    want = np.asarray(ref_ops.flash_attention(q, k, v, causal=True))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got[:, :, 0], np.repeat(v[:, :, 0], 2, 1),
                               rtol=1e-6, atol=1e-6)
    bottom_right = np.asarray(ref_kernel_ref.attention_ref(q, k, v,
                                                           causal=True))
    assert not np.allclose(got, bottom_right, atol=1e-2)


def test_flash_attention_rows_sum_preserved():
    """softmax rows sum to 1, so attention of a constant V returns the
    constant (test_kernels.py:148)."""
    b, hq, hk, s, d = 1, 4, 2, 128, 32
    q = torch.from_numpy(_normal((b, hq, s, d), 1))
    k = torch.from_numpy(_normal((b, hk, s, d), 2))
    v = torch.full((b, hk, s, d), 3.5)
    out = ops.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), 3.5, rtol=1e-5)


def test_flash_attention_plain_steps_online():
    """The plain version's 128-wide online softmax equals one full-row
    softmax (f64 direct) within f32 rounding, with the padded-key mask
    (kv_len) and GQA."""
    q = torch.from_numpy(_normal((2, 6, 128, 16), 4))
    k = torch.from_numpy(_normal((2, 3, 384, 16), 5))
    v = torch.from_numpy(_normal((2, 3, 384, 16), 6))
    got = flash_attention_ref(q, k, v, causal=False, kv_len=300)
    kd = k.double().repeat_interleave(2, 1)[:, :, :300]
    vd = v.double().repeat_interleave(2, 1)[:, :, :300]
    s = q.double() @ kd.transpose(-1, -2) / 4.0
    want = torch.softmax(s, -1) @ vd
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_operands_checked():
    """Shapes outside the contract raise before any kernel runs; CPU
    tensors launch nothing."""
    from repro_torch.kernels import flash_attention as fa
    before = dict(_cuda.LAUNCHES)
    q = torch.zeros(1, 3, 128, 16)
    with pytest.raises(ValueError, match="Hq % Hk"):
        fa.flash_attention(q, torch.zeros(1, 2, 128, 16),
                           torch.zeros(1, 2, 128, 16))
    with pytest.raises(ValueError, match="multiples of 128"):
        fa.flash_attention(torch.zeros(1, 2, 100, 16),
                           torch.zeros(1, 2, 128, 16),
                           torch.zeros(1, 2, 128, 16))
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.flash_attention(q, q, q, bq=64)
    ops.flash_attention(q, q, q)
    assert _cuda.LAUNCHES == before


# ---------------------------------------------------------------- layers
def test_rmsnorm_matches_reference():
    x, w = _normal((2, 5, 64), 1), 1.0 + 0.1 * _normal((64,), 2)
    want = ref_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("partial", [1.0, 0.5])
def test_rope_matches_reference(partial):
    """Tables and rotation (pairs 0::2 with 1::2, first int(hd*partial)
    dims) at positions up to 2000, in f32: cos/sin of angles up to 2000
    rad agree within a few f32 ulps of the angle."""
    hd = 32
    rot = int(hd * partial)
    pos = np.array([0, 1, 7, 63, 2000], np.int32)
    cj, sj = ref_layers.rope_tables(jnp.asarray(pos), rot, 500_000.0)
    ct, st = layers.rope_tables(torch.from_numpy(pos), rot, 500_000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=5e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=5e-4)
    x = _normal((2, 5, 3, hd), 3)
    want = ref_layers.apply_rope(jnp.asarray(x), cj, sj, rot)
    got = layers.apply_rope(torch.from_numpy(x), ct, st, rot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    # the same tables on both sides: the rotation itself agrees to f32
    got2 = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        np.array(cj)), torch.from_numpy(np.array(sj)), rot)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., rot:].numpy(), x[..., rot:])


def _attn_inputs(b=2, sq=96, t=96, hq=8, hk=2, hd=32, seed=0):
    return (_normal((b, sq, hq, hd), seed), _normal((b, t, hk, hd), seed + 1),
            _normal((b, t, hk, hd), seed + 2))


@pytest.mark.parametrize("causal,hq,hk", [(True, 8, 2), (False, 8, 2),
                                          (True, 4, 4), (True, 8, 1)])
def test_dense_attention_matches_reference(causal, hq, hk):
    q, k, v = _attn_inputs(sq=96, t=96, hq=hq, hk=hk)
    want = ref_layers.dense_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
    got = layers.dense_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,hq,hk", [(True, 8, 2), (False, 8, 2),
                                          (True, 4, 4)])
def test_chunked_attention_matches_reference(causal, hq, hk):
    """Two q chunks, two kv chunks, padded keys (t = 100 to 128)."""
    q, k, v = _attn_inputs(sq=100, t=100, hq=hq, hk=hk)
    want = ref_layers.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=causal, chunk_q=64,
                                        chunk_k=64)
    got = layers.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, chunk_q=64, chunk_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    dense = layers.dense_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("pos,hq,hk", [(0, 8, 2), (37, 8, 2), (63, 8, 2),
                                       (37, 4, 4), (63, 8, 1)])
def test_decode_attention_matches_reference(pos, hq, hk):
    """A cache of T = 64 slots, filled up to ``pos``."""
    q, k, v = _attn_inputs(sq=1, t=64, hq=hq, hk=hk)
    want = ref_layers.decode_attention(*map(jnp.asarray, (q, k, v)),
                                       jnp.int32(pos))
    got = layers.decode_attention(*map(torch.from_numpy, (q, k, v)), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_swiglu_matches_reference():
    x = _normal((2, 5, 32), 1)
    p = {n: _normal(s, i) * 0.2 for i, (n, s) in enumerate(
        [("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32))])}
    want = ref_layers.swiglu({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x))
    got = layers.swiglu({n: torch.from_numpy(a) for n, a in p.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------- whole models
B, S = 2, 48
# Whole models agree with the reference within this fraction of the
# compared tensor's largest magnitude.  The reference's fan_in rule takes
# wq's fan as its shape[-2], n_heads (4 in reduced()), so hidden states
# reach ~100 and attention at random weights is sharply peaked; f32
# summation-order differences grow through four layers to at most 4.4e-4
# of the scale (measured over the four configs), so 2e-3 has a 4x margin.
SCALED = 2e-3


def _close_scaled(got, want, rel=SCALED):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _reduced(name):
    return dataclasses.replace(REF_ARCHS[name].reduced(), dtype="float32")


@pytest.fixture(scope="module")
def models():
    """Per dense arch: (reference config, reference params, port config,
    port params converted from the reference's, tokens)."""
    out = {}
    rng = np.random.default_rng(3)
    for name in DENSE:
        rcfg = _reduced(name)
        rp = ref_init(ref_zoo.model_specs(rcfg), jax.random.PRNGKey(0),
                      rcfg.dtype)
        cfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
        tp = params_from_reference(jax.tree.map(np.asarray, rp),
                                   device="cpu")
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out[name] = (rcfg, rp, cfg, tp, tokens)
    return out


def test_configs_equal_reference():
    """The port's dense configs and their reductions field for field."""
    for name in DENSE:
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(REF_ARCHS[name])
        assert dataclasses.asdict(get_arch(name).reduced()) == \
            dataclasses.asdict(REF_ARCHS[name].reduced())
    assert sorted(ARCHS) == sorted(n for n, c in REF_ARCHS.items()
                                   if c.family == "dense")


@pytest.mark.parametrize("name", sorted(set(REF_ARCHS) - set(ARCHS)))
def test_other_archs_not_ported(name):
    """The six non-dense archs: KeyError naming ROADMAP A14; their
    configs, carried over by hand, raise NotImplementedError."""
    with pytest.raises(KeyError, match="A14"):
        get_arch(name)
    ref = REF_ARCHS[name]
    cfg = ModelConfig(**{f.name: getattr(ref, f.name)
                         for f in dataclasses.fields(RefConfig)
                         if f.name not in ("moe", "ssm")})
    for call in (lambda: zoo.model_specs(cfg),
                 lambda: zoo.prefill_fn(cfg, 64),
                 lambda: zoo.decode_fn(cfg)):
        with pytest.raises(NotImplementedError, match="A14"):
            call()


def test_sliding_window_not_ported():
    """A dense config with a sliding window raises too, on every entry
    point, and never runs a plain path."""
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              sliding_window=32)
    tokens = torch.zeros(1, 8, dtype=torch.int32)
    for call in (lambda: zoo.model_specs(cfg),
                 lambda: zoo.prefill_fn(cfg, 64),
                 lambda: transformer.forward_seq({}, tokens, cfg),
                 lambda: transformer.decode_step({}, tokens[:, 0],
                                                 {"pos": 0, "k": None,
                                                  "v": None}, cfg)):
        with pytest.raises(NotImplementedError, match="A14"):
            call()


def test_params_from_reference_leaves(models):
    """Leaf names, shapes and dtypes equal the reference tree's; the
    values are the reference's bit for bit; ``dtype`` casts all but the
    norm weights."""
    rcfg, rp, cfg, tp, _ = models["llama3-8b"]
    flat_r = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(rp)[0]}

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{pre}['{k}']").items()}
        return {pre: t}

    flat_t = flat(tp)
    assert sorted(flat_t) == sorted(flat_r)
    for k, a in flat_r.items():
        assert tuple(flat_t[k].shape) == a.shape
        assert flat_t[k].dtype == torch.float32 and a.dtype == np.float32
        np.testing.assert_array_equal(flat_t[k].numpy(), np.asarray(a))
    bf = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu",
                               dtype=torch.bfloat16)
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.float32
    assert bf["layers"]["mlp_norm"].dtype == torch.float32
    # bf16 reference leaves come across bit for bit
    rb = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                      {"w": rp["embed"]})
    tb = params_from_reference(rb, device="cpu")
    assert tb["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["w"].view(torch.int16).numpy(),
        np.asarray(rb["w"]).view(np.int16))


def test_init_params_shapes_and_scale():
    """``init_params`` gives the specs' shapes and dtypes; its fan_in
    leaves have std within 10% of scale / sqrt(fan), ``normal`` leaves
    0.02, norms are ones; one generator seed gives the same tree."""
    cfg = get_arch("llama3-8b").reduced()
    specs = zoo.model_specs(cfg)
    p = init_params(specs, torch.Generator().manual_seed(0), "float32",
                    device="cpu")
    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] \
            if isinstance(t, dict) else [t]

    assert count_params(specs) == sum(t.numel() for t in leaves(p))
    lay = p["layers"]
    assert lay["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                       cfg.n_heads, cfg.hd)
    assert lay["mlp"]["w2"].shape == (cfg.n_layers, cfg.d_ff, cfg.d_model)
    assert p["lm_head"].shape == (cfg.d_model, cfg.vocab)
    for w, fan in ((lay["attn"]["wq"], cfg.n_heads),
                   (lay["attn"]["wo"], cfg.hd),
                   (lay["mlp"]["w1"], cfg.d_model),
                   (lay["mlp"]["w2"], cfg.d_ff),
                   (p["lm_head"], cfg.d_model)):
        assert abs(float(w.std()) * np.sqrt(fan) - 1.0) <= 0.1
    assert abs(float(p["embed"].std()) / 0.02 - 1.0) <= 0.1
    assert torch.equal(lay["attn_norm"], torch.ones_like(lay["attn_norm"]))
    bf = init_params(specs, torch.Generator().manual_seed(0), "bfloat16",
                     device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.float32
    again = init_params(specs, torch.Generator().manual_seed(0), "float32",
                        device="cpu")
    assert torch.equal(again["layers"]["mlp"]["w1"], lay["mlp"]["w1"])


@pytest.mark.parametrize("name", DENSE)
def test_forward_prefill_decode_match_reference(models, name):
    """forward_seq logits, prefill (tokens[:, :-1]) and one decode step
    (tokens[:, -1]) and the caches against the reference's on the same
    parameters and tokens, f32, within SCALED."""
    rcfg, rp, cfg, tp, tokens = models[name]
    x, _, _ = ref_forward(rp, jnp.asarray(tokens), rcfg)
    want_full = np.asarray(ref_unembed(rp, x, rcfg))
    xt, aux, kv = transformer.forward_seq(tp, torch.from_numpy(tokens), cfg,
                                          collect_cache=True)
    full = transformer._unembed(tp, xt, cfg)
    _close_scaled(full, want_full)
    assert kv[0].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    assert float(aux["load_balance"]) == 0.0

    lj, cj = jax.jit(ref_zoo.prefill_fn(rcfg, S + 8))(
        rp, {"tokens": jnp.asarray(tokens[:, :-1])})
    dj, cj = jax.jit(ref_zoo.decode_fn(rcfg))(rp, jnp.asarray(tokens[:, -1]),
                                              cj)
    lt, ct = zoo.prefill_fn(cfg, S + 8)(
        tp, {"tokens": torch.from_numpy(tokens[:, :-1])})
    _close_scaled(lt, lj)
    dt, ct = zoo.decode_fn(cfg)(tp, torch.from_numpy(tokens[:, -1]), ct)
    _close_scaled(dt, dj)
    _close_scaled(ct["k"], cj["k"])
    _close_scaled(ct["v"], cj["v"])
    assert ct["pos"] == int(cj["pos"]) == S


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_matches_forward(models, name):
    """The port's own serving contract (test_models.py:59): prefill of
    tokens[:, :-1] then decode of tokens[:, -1] give forward_seq's logits
    at -2 and -1, at that test's tolerances."""
    _, _, cfg, tp, tokens = models[name]
    t = torch.from_numpy(tokens)
    x, _, _ = transformer.forward_seq(tp, t, cfg)
    full = transformer._unembed(tp, x, cfg)
    lp, cache = zoo.prefill_fn(cfg, S + 8)(tp, {"tokens": t[:, :-1]})
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, -2].numpy(),
                               rtol=2e-3, atol=2e-3)
    ld, cache = zoo.decode_fn(cfg)(tp, t[:, -1], cache)
    np.testing.assert_allclose(ld[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)
    assert cache["pos"] == S


def test_chunked_model_path_matches_reference(models):
    """attn_impl="chunked" with sequences longer than attn_chunk takes
    the chunked path on both sides (transformer.py:105)."""
    rcfg, rp, cfg, tp, tokens = models["chatglm3-6b"]
    rcfg = dataclasses.replace(rcfg, attn_impl="chunked", attn_chunk=16)
    cfg = dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=16)
    x, _, _ = ref_forward(rp, jnp.asarray(tokens), rcfg)
    xt, _, _ = transformer.forward_seq(tp, torch.from_numpy(tokens), cfg)
    _close_scaled(xt, x)


def test_batches_equal_reference():
    """make_batch draws the reference's tokens for the same seed;
    train cells wait for the training slice."""
    cfg = get_arch("llama3-8b").reduced()
    for cell in (ShapeCell("p", 64, 2, "prefill"),
                 ShapeCell("d", 64, 2, "decode")):
        got = zoo.make_batch(cfg, cell, seed=5, device="cpu")
        want = ref_zoo.make_batch(REF_ARCHS["llama3-8b"].reduced(), cell, 5)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(NotImplementedError, match="train"):
        zoo.batch_desc(cfg, ShapeCell("t", 64, 2, "train"))


def test_cache_spec_matches_reference():
    cfg = get_arch("chatglm3-6b")
    want = ref_zoo.cache_desc(REF_ARCHS["chatglm3-6b"],
                              ShapeCell("d", 512, 3, "decode"))
    assert transformer.cache_spec(cfg, 3, 512) == want
    cache = transformer.init_cache(cfg.reduced(), 2, 16, device="cpu")
    assert cache["pos"] == 0 and cache["k"].dtype == torch.bfloat16


# ------------------------------------------------------ the retrieval twin
ENCODER = dict(name="encoder-20m", family="dense", n_layers=4, d_model=256,
               n_heads=4, n_kv_heads=4, d_ff=1024, vocab=8192, head_dim=64,
               attn_impl="dense", remat="none", dtype="float32")


def test_retrieval_twin_matches_reference():
    """examples/retrieval_serving.py steps 1-3, reduced to 10 anchors x 20
    edited variants: the port's mean-pooled, truncated embeddings match
    the reference's ``encode`` on the same parameters (f32, SCALED), and
    the port's BatchedLIMS kNN (k = 5) over them equals a brute-force
    f64 scan of the port's embeddings."""
    rcfg = RefConfig(**ENCODER)
    cfg = ModelConfig(**ENCODER)
    rp = ref_init(ref_zoo.model_specs(rcfg), jax.random.PRNGKey(0),
                  rcfg.dtype)
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(0)
    anchors = rng.integers(0, cfg.vocab, (10, 32))
    docs = np.repeat(anchors, 20, axis=0)
    for i in range(len(docs)):
        docs[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)
    queries = anchors[:8].copy()
    for i in range(8):
        queries[i, rng.integers(0, 32)] = rng.integers(0, cfg.vocab)

    def encode_ref(tokens):
        x, _, _ = ref_forward(rp, jnp.asarray(tokens, jnp.int32), rcfg)
        return np.asarray(x.mean(axis=1)[:, :32])

    def encode(tokens):
        x, _, _ = transformer.forward_seq(
            tp, torch.from_numpy(tokens.astype(np.int32)), cfg)
        return x.mean(dim=1)[:, :32].numpy()

    corpus, q_emb = encode(docs), encode(queries)
    _close_scaled(corpus, encode_ref(docs))
    _close_scaled(q_emb, encode_ref(queries))
    data = corpus.astype(np.float64)
    ix = LIMSIndex(MetricSpace(data, "l2"), n_clusters=10, m=3, n_rings=20)
    ids, ds = BatchedLIMS(ix, device="cpu").knn_query_batch(
        q_emb.astype(np.float64), 5)
    for i, q in enumerate(q_emb.astype(np.float64)):
        d_all = dist_one_to_many(q, data, "l2")
        top = np.argsort(d_all, kind="stable")[:5]
        np.testing.assert_array_equal(ds[i], d_all[top])
        assert sorted(ids[i]) == sorted(top)
