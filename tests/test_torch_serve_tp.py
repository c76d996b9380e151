"""LM prefill and decode over ranks (batch on the data axis; heads, the
MLP or experts, the vocabulary and the KV cache's sequence on the model
axis) for the attention families, over W = 4 gloo ranks on the CPU.

One module-scoped spawn (``launch.ranks.run_ranks``, backend gloo) runs
every case on two meshes of the four ranks
(``make_host_mesh(model_parallel=...)``): (data 1, model 4) and (data 2,
model 2).  Each rank cuts the whole parameters to its chunks
(``zoo.rank_params``), takes its data coordinate's rows of the global
batch (4 rows) and runs ``zoo.prefill_fn(cfg, cache_len, mesh)`` and 8
greedy ``zoo.decode_fn(cfg, mesh)`` steps, each step's token the argmax
of the last logits.  The configurations, each reduced and in f32 (4
layers, d_model 128, vocabulary 512):

* ``llama``: 4 q heads over 2 kv heads, cache of 64 slots, prompt 20:
  on (1, 4) each rank holds 16 slots of every kv head, and ranks 2 and
  3 hold no valid slot until the decode reaches them (they add l = 0,
  o = 0 to the merge); on (2, 2) 32 slots each;
* ``llama-t31``: a cache of 31 slots, which divides neither line: the
  guard leaves ``kv_seq`` whole, so on (1, 4) the cache is whole on
  every rank (its 2 kv heads do not divide 4 either) and on (2, 2) it
  splits the kv heads, each rank attending its own;
* ``uneven``: 12 q heads over 3 kv heads (d_head 16): the kv weights
  stay whole on both lines and a rank's q heads take their kv heads
  unevenly (rank 1 of 4: kv heads 0, 1, 1), so prefill computes every
  kv head for the cache from the whole weights;
* ``mixtral``: the sliding window of 32 with a prompt of 44, so prefill
  rolls the last 32 positions into the ring, and the 8 decode steps
  write slots 12-19, across a shard boundary on both lines; MoE
  dispatch in 2 groups (a multiple of the data ranks);
* ``kimi``: the MoE with its shared expert, experts split over the
  line;
* ``llava``: the 8-position image prefix before 20 text tokens;
* ``internlm2``: FSDP weights (``embed`` on ``data`` as well), gathered
  one layer at a time in prefill and in every decode step.

Held in the parent: the prefill's logits and the cache gathered back
whole (``collective.whole``) after prefill and after the last step,
and each decode step's logits, within ``TOL`` of the compared tensor's
largest magnitude of the port's one-process prefill and decode on the
global batch, and no further from the reference's (its jitted
``prefill_fn`` / ``decode_fn``, fed the same tokens) than the
one-process port is plus ``TOL`` of it; the greedy tokens equal the
one-process port's and the reference's argmax; each rank's cache bytes
equal the shard bytes of ``launch.dryrun.cache_specs`` on the mesh; the
cache layout each case expects.  Besides: mamba2 (ssm), zamba2
(hybrid) and seamless (encdec) prefill and decode under a model line
raise ``NotImplementedError`` naming ROADMAP Queue A item 10(b), and
mamba2 over a data line of two ranks (two such lines of the four)
equals the one-process prefill and decode.  The matrices are scaled by
``SCALE``, as the tensor-parallel training tests scale them.  ``jax``
and ``repro`` are imported in the parent's fixtures only.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeCell
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataShard, shard_rows
from repro_torch.launch.dryrun import cache_specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import layers, zoo
from repro_torch.sharding import collective
from repro_torch.sharding.logical import LogicalMesh, default_rules
from repro_torch.train import optim

W = 4
MESHES = {"tp4": (1, 4), "dp2tp2": (2, 2)}      # (data, model)
ROWS = 4                        # the global batch
STEPS = 8                       # greedy decode steps
TOL = 1e-5                      # of the compared tensor's largest |value|
SCALE = 0.5                     # every matrix of the drawn parameters
# id: (arch, config overrides, cache_len, prompt tokens, FSDP weights)
CONFIGS = {
    "llama": ("llama3-8b", {}, 64, 20, False),
    "llama-t31": ("llama3-8b", {}, 31, 20, False),
    "uneven": ("llama3-8b", {"n_heads": 12, "n_kv_heads": 3,
                             "head_dim": 16}, 64, 20, False),
    "mixtral": ("mixtral-8x7b", {"moe_dispatch_groups": 2}, 64, 44, False),
    "kimi": ("kimi-k2-1t-a32b", {"moe_dispatch_groups": 2}, 64, 20, False),
    "llava": ("llava-next-34b", {}, 64, 20, False),
    "internlm2": ("internlm2-20b", {}, 64, 20, True),
}
CASES = [(f"{c}-{m}", c, m) for c in CONFIGS for m in MESHES]
IDS = [c[0] for c in CASES]
# the cache's model split each case expects: the dim of (layers, batch,
# kv_seq, kv_heads, qkv) that the guard puts on "model", or None
LAYOUT = {"llama-t31-tp4": None, "llama-t31-dp2tp2": 3}
REFUSED = {"mamba2": "mamba2-780m", "zamba2": "zamba2-2.7b",
           "seamless": "seamless-m4t-large-v2"}
DATA_ONLY = ("mamba2-780m", 48, 24)     # arch, cache_len, prompt tokens


def _cfg(cid):
    arch, over, *_ = CONFIGS[cid]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                               **over)


def _case(case_id):
    return next(c for c in CASES if c[0] == case_id)


def _batch(cfg, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (ROWS, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            0, 0.02, (ROWS, cfg.n_prefix_embeds, cfg.d_model)).astype(
                np.float32)
    return out


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(t):
    return t.detach().float().numpy().copy()


def _scaled(tree):
    """Every matrix (a leaf of 2 or more dims) times SCALE."""
    return optim.tree_map(lambda a: a * SCALE if a.ndim >= 2 else a, tree)


def _greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _serve(prefill, decode, params, batch, whole=lambda c: c):
    """Prefill, then STEPS greedy decode steps: the logits of each, the
    tokens fed, and the cache (through ``whole``) after prefill and
    after the last step."""
    logits, cache = prefill(params, batch)
    out = {"logits": [_np(logits)], "tokens": [],
           "cache0": {k: _np(v) for k, v in whole(cache).items()
                      if k != "pos"}}
    for _ in range(STEPS):
        tok = _greedy(logits)
        out["tokens"].append(tok.numpy().copy())
        logits, cache = decode(params, tok, cache)
        out["logits"].append(_np(logits))
    out["cache"] = {k: _np(v) for k, v in whole(cache).items() if k != "pos"}
    out["pos"] = cache["pos"]
    return out, cache


# ------------------------------------------------------------ rank bodies
def _local(mesh, batch):
    """This rank's block of ``batch``: its data coordinate's."""
    return shard_rows(_tensors(batch), DataShard(mesh.coords()["data"],
                                                 mesh.shape["data"]))


def _whole(cache):
    return {k: collective.whole(v) if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _cases(meshes, ref_params, batches):
    out = {}
    for cid, key, mid in CASES:
        cfg, mesh = _cfg(key), meshes[mid]
        _, _, cache_len, _, fsdp = CONFIGS[key]
        chunks = zoo.rank_params(cfg, params_from_reference(
            ref_params[key], device="cpu"), mesh, fsdp=fsdp)
        got, cache = _serve(zoo.prefill_fn(cfg, cache_len, mesh),
                            zoo.decode_fn(cfg, mesh), chunks,
                            _local(mesh, batches[key]), _whole)
        got["bytes"] = {k: v.numel() * v.element_size()
                        for k, v in cache.items() if k != "pos"}
        split = collective.model_of(cache["k"])
        got["layout"] = None if split is None else split.dim
        got["data"] = mesh.coords()["data"]
        out[cid] = got
    return out


def _refusals(mesh, ref_params):
    """Prefill and a decode step of each family left for item 10(b)
    under the (1, 4) line: the messages they raise (None where none)."""
    def raises(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None
    out = {}
    for key, arch in REFUSED.items():
        cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        chunks = zoo.rank_params(cfg, params_from_reference(
            ref_params[key], device="cpu"), mesh)
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.zeros((2, 8, cfg.d_model))
        cache = zoo.prefill_fn(cfg, 16)(params_from_reference(
            ref_params[key], device="cpu"), batch)[1]
        out[key + "-prefill"] = raises(
            lambda: zoo.prefill_fn(cfg, 16, mesh)(chunks, batch))
        out[key + "-decode"] = raises(
            lambda: zoo.decode_fn(cfg, mesh)(chunks, batch["tokens"][:, 0],
                                              cache))
    return out


def _data_only(rank, device, ref_params, batch):
    """mamba2 over a data line of two ranks: ranks 0, 1 and ranks 2, 3
    each a (2, 1) mesh of their own group."""
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    mesh = LogicalMesh(("data", "model"), (2, 1), group=groups[rank // 2],
                       device=device)
    arch, cache_len, _ = DATA_ONLY
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    params = zoo.rank_params(cfg, params_from_reference(ref_params,
                                                        device="cpu"), mesh)
    got, _ = _serve(zoo.prefill_fn(cfg, cache_len, mesh),
                    zoo.decode_fn(cfg, mesh), params, _local(mesh, batch),
                    _whole)
    got["data"] = mesh.coords()["data"]
    return got


def _rank_body(rank, device, ref_params, batches):
    torch.set_num_threads(1)
    meshes = {mid: make_host_mesh(model_parallel=m, device=device)
              for mid, (_, m) in MESHES.items()}
    return {"cases": _cases(meshes, ref_params, batches),
            "refusals": _refusals(meshes["tp4"], ref_params),
            "data_only": _data_only(rank, device, ref_params["mamba2"],
                                    batches["mamba2"])}


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def R():
    """jax and the reference's modules (imported in the parent only)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import registry
    from repro.models import params, zoo as rzoo
    return SimpleNamespace(jax=jax, jnp=jnp, ARCHS=registry.ARCHS,
                           zoo=rzoo, init=params.init_params)


def _ref_cfg(R, arch, over=None):
    return dataclasses.replace(R.ARCHS[arch].reduced(), dtype="float32",
                               **(over or {}))


@pytest.fixture(scope="module")
def inputs(R):
    """Per configuration the reference's initial parameters (numpy,
    matrices x SCALE) and the global batch; the refused families' and
    the data-only case's too."""
    params, batches = {}, {}
    for i, (key, (arch, over, _, s, _)) in enumerate(CONFIGS.items()):
        rcfg = _ref_cfg(R, arch, over)
        params[key] = _scaled(R.jax.tree.map(np.asarray, R.init(
            R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(i), "float32")))
        batches[key] = _batch(_cfg(key), s, seed=i)
    for key, arch in REFUSED.items():
        rcfg = _ref_cfg(R, arch)
        params[key] = _scaled(R.jax.tree.map(np.asarray, R.init(
            R.zoo.model_specs(rcfg), R.jax.random.PRNGKey(0), "float32")))
    arch, _, s = DATA_ONLY
    batches["mamba2"] = _batch(get_arch(arch).reduced(), s, seed=99)
    return params, batches


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank body on the W = 4 gloo ranks (one spawn)."""
    params, batches = inputs
    return run_ranks(_rank_body, W, (params, batches), backend="gloo",
                     timeout_s=600)


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread while the module's fixtures run in the parent
    (the models are small, and the ranks and the other workers share
    the host's cores), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def one_process(inputs, one_thread):
    """Per configuration the port's one-process prefill and greedy decode
    on the global batch."""
    params, batches = inputs
    out = {}
    for key, (_, _, cache_len, _, _) in CONFIGS.items():
        cfg = _cfg(key)
        out[key] = _serve(zoo.prefill_fn(cfg, cache_len), zoo.decode_fn(cfg),
                          params_from_reference(params[key], device="cpu"),
                          _tensors(batches[key]))[0]
    arch, cache_len, _ = DATA_ONLY
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    out["mamba2"] = _serve(zoo.prefill_fn(cfg, cache_len), zoo.decode_fn(cfg),
                           params_from_reference(params["mamba2"],
                                                 device="cpu"),
                           _tensors(batches["mamba2"]))[0]
    return out


@pytest.fixture(scope="module")
def reference(R, inputs, one_process):
    """Per configuration the reference's jitted prefill and decode on the
    global batch, each step fed the one-process port's greedy token:
    the logits of each and the cache after prefill and after the last
    step."""
    params, batches = inputs
    out = {}
    for key, (arch, over, cache_len, _, _) in CONFIGS.items():
        rcfg = _ref_cfg(R, arch, over)
        rp = R.jax.tree.map(R.jnp.asarray, params[key])
        logits, cache = R.jax.jit(R.zoo.prefill_fn(rcfg, cache_len))(
            rp, {k: R.jnp.asarray(v) for k, v in batches[key].items()})
        got = {"logits": [np.asarray(logits)],
               "cache0": {k: np.asarray(cache[k]) for k in ("k", "v")}}
        step = R.jax.jit(R.zoo.decode_fn(rcfg))
        for tok in one_process[key]["tokens"]:
            logits, cache = step(rp, R.jnp.asarray(tok), cache)
            got["logits"].append(np.asarray(logits))
        got["cache"] = {k: np.asarray(cache[k]) for k in ("k", "v")}
        out[key] = got
    return out


# ----------------------------------------------------------------- helpers
def _rows(ranks, case_id, what):
    """A case's per-rank rows of ``what`` joined in data order (one rank
    a data coordinate; the model line's ranks hold the same, checked)."""
    _, _, mid = _case(case_id)
    m = MESHES[mid][1]
    for r in range(W):
        lead = ranks[r - r % m]["cases"][case_id][what]
        for a, b in zip(ranks[r]["cases"][case_id][what], lead):
            assert np.array_equal(a, b), (case_id, what, r)
    return [np.concatenate(parts) for parts in zip(
        *(ranks[d * m]["cases"][case_id][what] for d in range(W // m)))]


def _scale(want):
    return float(np.abs(want).max())


def _held(got, one, ref, what=""):
    """``got`` within TOL of ``one``'s scale of ``one``, and no further
    from ``ref`` than ``one`` is plus TOL of its scale."""
    got, one, ref = (np.asarray(x, np.float32) for x in (got, one, ref))
    assert got.shape == one.shape == ref.shape, (what, got.shape, one.shape)
    err = np.abs(got - one).max()
    assert err <= TOL * _scale(one), (what, err, _scale(one))
    bar = np.abs(one - ref).max() + TOL * _scale(ref)
    assert np.abs(got - ref).max() <= bar, (what, np.abs(got - ref).max(),
                                           bar)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("case_id", IDS)
def test_prefill_logits_and_cache_match(ranks, one_process, reference,
                                        case_id):
    """Prefill's last-position logits (whole vocabulary on every rank of
    the line) and the cache gathered whole after it, against the
    one-process port and the reference."""
    _, key, _ = _case(case_id)
    one, ref = one_process[key], reference[key]
    _held(_rows(ranks, case_id, "logits")[0], one["logits"][0],
          ref["logits"][0], "prefill")
    got = ranks[0]["cases"][case_id]["cache0"]
    for r in ranks:
        for name in ("k", "v"):
            assert np.array_equal(r["cases"][case_id]["cache0"][name],
                                  got[name])
    for name in ("k", "v"):
        _held(got[name], one["cache0"][name], ref["cache0"][name], name)


@pytest.mark.parametrize("case_id", IDS)
def test_decode_steps_match(ranks, one_process, reference, case_id):
    """Eight greedy decode steps: every step's logits against the
    one-process port and the reference, the tokens equal to the
    one-process port's and to the reference's argmax, and the cache
    gathered whole after the last step."""
    _, key, _ = _case(case_id)
    one, ref = one_process[key], reference[key]
    got = _rows(ranks, case_id, "logits")
    toks = _rows(ranks, case_id, "tokens")
    assert len(got) == STEPS + 1 and len(toks) == STEPS
    for i in range(1, STEPS + 1):
        _held(got[i], one["logits"][i], ref["logits"][i], f"step {i}")
    for i, (t, want) in enumerate(zip(toks, one["tokens"])):
        assert np.array_equal(t, want), (i, t, want)
        assert np.array_equal(t, np.argmax(ref["logits"][i][:, -1], -1))
    assert ranks[0]["cases"][case_id]["pos"] == one["pos"]
    for name in ("k", "v"):
        _held(ranks[0]["cases"][case_id]["cache"][name], one["cache"][name],
              ref["cache"][name], name)


@pytest.mark.parametrize("case_id", IDS)
def test_cache_bytes_equal_cache_specs(ranks, case_id):
    """Each rank's cache bytes equal the shard bytes of the dry-run's
    ``cache_specs`` on the case's mesh under ``default_rules()``, and
    the cache splits where the case expects it (``LAYOUT``; ``kv_seq``,
    dim 2, elsewhere)."""
    _, key, mid = _case(case_id)
    cfg, cache_len = _cfg(key), CONFIGS[key][2]
    specs = cache_specs(cfg, ShapeCell("serve", cache_len, ROWS, "decode"),
                        LogicalMesh(("data", "model"), MESHES[mid]),
                        default_rules())
    want = {k: int(np.prod(t.sharding.shard_shape(tuple(t.shape))))
            * t.element_size() for k, t in specs.items() if t.dim()}
    whole = sum(t.numel() * t.element_size() for t in specs.values()
                if t.dim())
    for r in ranks:
        got = r["cases"][case_id]
        assert got["bytes"] == want
        assert got["layout"] == LAYOUT.get(case_id, 2)
    split = LAYOUT.get(case_id, 2) is not None or MESHES[mid][0] > 1
    assert (sum(want.values()) < whole) == split


@pytest.mark.parametrize("what", ["mamba2-prefill", "mamba2-decode",
                                  "zamba2-prefill", "zamba2-decode",
                                  "seamless-prefill", "seamless-decode"])
def test_families_left_for_item_10b_raise(ranks, what):
    """The ssm, hybrid and encdec families' prefill and decode under a
    model line raise NotImplementedError naming ROADMAP Queue A item
    10(b), on every rank."""
    for r in ranks:
        msg = r["refusals"][what]
        assert msg is not None and "Queue A item 10(b)" in msg, (what, msg)


@pytest.mark.parametrize("what", ["logits", "cache"])
def test_mamba2_over_a_data_line_equals_one_process(ranks, one_process,
                                                    what):
    """mamba2 over a (2, 1) mesh (each pair of ranks a data line of its
    own) runs each rank's rows: its prefill and decode logits and its
    conv and ssm caches, gathered whole, within TOL of the one-process
    port's on the global batch; the tokens are the one-process port's."""
    one = one_process["mamba2"]
    for pair in ((0, 1), (2, 3)):
        got = [ranks[r]["data_only"] for r in pair]
        assert [g["data"] for g in got] == [0, 1]
        if what == "logits":
            for i in range(STEPS + 1):
                a = np.concatenate([g["logits"][i] for g in got])
                assert np.abs(a - one["logits"][i]).max() <= \
                    TOL * _scale(one["logits"][i]), i
            for i in range(STEPS):
                assert np.array_equal(np.concatenate(
                    [g["tokens"][i] for g in got]), one["tokens"][i])
            continue
        for name in ("conv", "ssm"):
            for which in ("cache0", "cache"):
                a, want = got[0][which][name], one[which][name]
                assert np.array_equal(a, got[1][which][name])
                assert np.abs(a - want).max() <= TOL * _scale(want), name


def test_serving_group_spans_the_mesh_lines(ranks):
    """Every case ran on its mesh's data coordinate (rank r at r // m)."""
    for r, got in enumerate(ranks):
        for case_id, _, mid in CASES:
            assert got["cases"][case_id]["data"] == r // MESHES[mid][1]


@pytest.mark.parametrize("window, pos", [(None, 20), (None, 63), (32, 10),
                                         (32, 44)])
def test_decode_partials_merge_to_decode_attention(window, pos):
    """``layers.decode_partial`` over four chunks of a cache (its mask at
    the global slot indices), merged as ``collective.merge_softmax``
    merges them over a line, equals ``decode_attention`` on the whole
    cache within 1e-6 of the output's scale (f32); a chunk with no valid
    slot holds l = 0 and o = 0 exactly; with no line ``merge_softmax``
    of one part is that part normalised."""
    rng = np.random.default_rng(pos)
    t = 64 if window is None else 32
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 1, 4, 16), (2, t, 2, 16), (2, t, 2, 16)))
    want = layers.decode_attention(q, k, v, pos, window=window)
    one = collective.merge_softmax(*layers.decode_partial(q, k, v, pos, 0,
                                                          t, window))
    assert (one.reshape(want.shape) - want).abs().max() <= \
        1e-6 * want.abs().max()
    size = t // 4
    parts = [layers.decode_partial(q, k[:, c * size:(c + 1) * size],
                                   v[:, c * size:(c + 1) * size], pos,
                                   c * size, t, window) for c in range(4)]
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = sum(part * torch.exp(m - top) for m, part, _ in parts)
    o = sum(part * torch.exp(m - top)[..., None] for m, _, part in parts)
    got = (o / l[..., None]).reshape(want.shape)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    empty = [c for c in range(4) if c * size > pos]
    assert empty == ([2, 3] if pos in (20, 10) else [])
    for c in empty:
        assert torch.all(parts[c][1] == 0) and torch.all(parts[c][2] == 0)
