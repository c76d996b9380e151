"""The port's kernel tile autotuner against the reference's.

The table's keys, buckets and parsing equal the reference's
(``repro/kernels/autotune.py``); the table's load, merge, validation and
its corrupted and truncated caches are the twins of
``tests/test_autotune.py``'s, with the card's timings (``_time_us``,
``_paired_us``) and its seeded operands (``_Bench``) replaced by fixed
stand-ins, since the CPU has no tiles to time.  The ``gpu`` tests run
every candidate tile of every kernel on the card against its plain
version, and a tuned table against the static tiles.  The reference is
imported inside a fixture, so those collect where JAX is absent.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import env
from repro_torch.kernels import _cuda, autotune, ops
from repro_torch.kernels.fused import pdist_rankeval_plain
from repro_torch.kernels.pdist import METRICS, POINT_TYPES
from repro_torch.kernels.range_filter import range_filter_plain
from repro_torch.kernels.rankeval import rank_math_plain

BACKEND = "cuda-sm90"
_TINY = {"q": 16, "p": 64, "d": 8}


@pytest.fixture
def ref_autotune():
    return pytest.importorskip("repro.kernels.autotune")


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    """A private cache file, the in-memory table dropped around the
    test, and a card stand-in: the backend key fixed, the bench's
    operands a constant output and every tile timed by ``timings``
    (tile tuple -> us; 100 us where absent)."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(path))
    monkeypatch.setattr(autotune, "backend_key", lambda device=None: BACKEND)
    timings = {}

    def us(tiles):
        return timings.get(tuple(sorted(tiles.items())), 100.0)

    class Bench:
        def __init__(self, kernel, metric, bd, device):
            self.out = torch.arange(6.0)

        def call(self, tiles):
            thunk = (lambda: self.out.clone())
            thunk.tiles = tiles
            return thunk

        def plain(self):
            return self.out.clone()

    monkeypatch.setattr(autotune, "_Bench", Bench)
    monkeypatch.setattr(autotune, "_time_us", lambda thunk: us(thunk.tiles))
    monkeypatch.setattr(autotune, "_paired_us",
                        lambda a, b: (us(a.tiles), us(b.tiles)))
    autotune._reset()
    yield SimpleNamespace(path=path, timings=timings)
    autotune._reset()


def _tile_key(tiles):
    return tuple(sorted(tiles.items()))


# ------------------------------------------------------------ keys
def test_bucket_key_and_parse_equal_reference(ref_autotune):
    for n in list(range(0, 70)) + [127, 128, 129, 4095, 71_998, 4_607_872]:
        assert autotune.bucket(n) == ref_autotune.bucket(n)
    cases = [("pdist", "sql2", {"q": 64, "p": 4_607_872, "d": 8}),
             ("range_filter", "sql2", {"q": 3, "p": 5, "d": 33}),
             ("rankeval", None, {"g": 192, "b": 71_998, "c": 9}),
             ("pdist_rankeval", None, {"g": 192, "b": 64, "d": 8, "c": 9})]
    for kernel, metric, dims in cases:
        bd = {k: autotune.bucket(v) for k, v in dims.items()}
        key = autotune._key(BACKEND, kernel, metric, bd)
        assert key == ref_autotune._key(BACKEND, kernel, metric, bd)
        assert autotune._parse_key(key) == ref_autotune._parse_key(key) \
            == (BACKEND, kernel, metric, bd)
    for bad in ("cuda-sm90/pdist", "a/b/c/d=x", "a/b/c/d"):
        assert autotune._parse_key(bad) == ref_autotune._parse_key(bad)


def test_bucket_is_pow2_floor8():
    assert [autotune.bucket(v) for v in (1, 8, 9, 64, 65, 4096)] == \
        [8, 8, 16, 64, 128, 4096]
    a = autotune._key(BACKEND, "pdist", "sql2",
                      {k: autotune.bucket(v)
                       for k, v in {"q": 60, "p": 4000, "d": 8}.items()})
    b = autotune._key(BACKEND, "pdist", "sql2",
                      {k: autotune.bucket(v)
                       for k, v in {"q": 64, "p": 4096, "d": 8}.items()})
    assert a == b


# ----------------------------------------------------- the contract
@pytest.mark.parametrize("kernel,metric,dims", [
    ("pdist", "sql2", {"q": 64, "p": 4_607_872, "d": 8}),
    ("pdist", "l1", {"q": 1, "p": 3, "d": 784}),
    ("pdist_bf16", "sql2", {"q": 200, "p": 1000, "d": 8}),
    ("range_filter_f16", "sql2", {"q": 9, "p": 129, "d": 32}),
    ("rankeval", None, {"g": 192, "b": 71_998, "c": 9}),
    ("pdist_rankeval", None, {"g": 192, "b": 64, "d": 8, "c": 9})])
def test_candidates_validate_and_hold_the_static_tile(kernel, metric, dims):
    bd = {k: autotune.bucket(v) for k, v in dims.items()}
    cands = autotune._candidates(kernel, metric, bd)
    static = autotune.static_tiles(kernel, metric, bd)
    assert static in cands and len(cands) == len(
        {_tile_key(c) for c in cands})
    for c in cands:
        ent = {"tiles": c, "us": 1.0, "v": autotune.SCHEMA_VERSION}
        assert autotune._valid_entry(BACKEND, kernel, ent), c


def test_static_tiles_are_the_kernels_fixed_tiles():
    from repro_torch.kernels import fused, pdist, rankeval
    big = {"q": 64, "p": 4_607_872, "d": 8}
    for k in autotune._STREAM:
        assert autotune.static_tiles(k, "sql2", big) == pdist.STATIC_TILES
    assert pdist.STATIC_TILES == {"bq": 64, "bp": 512, "qb": 64}
    # a chunk cap of at least the bucket's rows is one chunk: clamped
    assert autotune.static_tiles("pdist", "sql2", {"q": 8, "p": 9, "d": 8}) \
        == {"bq": 8, "bp": 512, "qb": 8}
    assert autotune.static_tiles("rankeval", None, {}) == {"bb": 1024} \
        == rankeval.STATIC_TILES
    assert autotune.static_tiles("pdist_rankeval", None, {}) == \
        {"bg": 8, "bb": 8} == fused.STATIC_TILES


@pytest.mark.parametrize("kernel,tiles,want", [
    ("pdist", None, (512, 64)),
    ("pdist_bf16", {"bq": 16, "bp": 128, "qb": 16}, (128, 16)),
    ("range_filter_f16", {"bq": 32, "bp": 256, "qb": 32}, (256, 32)),
    ("pdist_l1", None, (512, 64)),
    ("rankeval", None, (1024,)),
    ("rankeval", {"bb": 512}, (512,)),
    ("pdist_rankeval", None, (8, 8)),
    ("pdist_rankeval", {"bg": 8, "bb": 16}, (16, 8))])
def test_tile_args_are_each_launchs_order(kernel, tiles, want):
    """One order of each kernel's tile ints, its module's, as its CUDA
    launch passes them: (bp, bq), (bb,), (bb, bg)."""
    assert autotune.tile_args(kernel, tiles) == want


@pytest.mark.parametrize("backend,kernel,tiles,ok", [
    (BACKEND, "pdist", {"bq": 64, "bp": 512, "qb": 64}, True),
    ("cuda-sm80", "range_filter_bf16", {"bq": 8, "bp": 128, "qb": 8}, True),
    # the reference's Pallas lanes and its CPU lane: never the port's
    ("gpu", "pdist", {"bq": 64, "bp": 512, "qb": 64}, False),
    ("xla-cpu", "pdist", {"bq": 64, "bp": 512, "qb": 64}, False),
    (BACKEND, "pdist", {"bq": 64, "bp": 384, "qb": 64}, False),
    (BACKEND, "pdist", {"bq": 64, "bp": 128, "qb": 64}, False),
    (BACKEND, "pdist", {"bq": 12, "bp": 512, "qb": 12}, False),
    (BACKEND, "pdist", {"bq": 64, "bp": 512, "qb": 32}, False),
    (BACKEND, "pdist", {"bq": 256, "bp": 1024, "qb": 256}, False),
    (BACKEND, "pdist", {"bq": 64, "bp": 512}, False),
    (BACKEND, "rankeval", {"bb": 2048}, True),
    (BACKEND, "rankeval", {"bg": 8, "bb": 1024}, False),
    (BACKEND, "rankeval", {"bb": 4096}, False),
    (BACKEND, "rankeval", {"bb": True}, False),
    (BACKEND, "pdist_rankeval", {"bg": 16, "bb": 8}, True),
    (BACKEND, "pdist_rankeval", {"bg": 32, "bb": 8}, False),
    (BACKEND, "pdist_l1", {"bq": 64, "bp": 512, "qb": 64}, False)])
def test_valid_entry_states_the_ports_rules(backend, kernel, tiles, ok):
    ent = {"tiles": tiles, "us": 1.0, "v": autotune.SCHEMA_VERSION}
    assert autotune._valid_entry(backend, kernel, ent) is ok
    assert not autotune._valid_entry(backend, kernel, dict(ent, v=2))
    assert not autotune._valid_entry(backend, kernel, dict(ent, us="fast"))


def test_shipped_defaults_parse_and_validate():
    data = json.loads(autotune._DEFAULTS_PATH.read_text())
    assert data["version"] == autotune.SCHEMA_VERSION
    entries = data["entries"]
    assert entries
    for key, ent in entries.items():
        backend, kernel, metric, bd = autotune._parse_key(key)
        assert backend.startswith("cuda-"), key
        assert autotune._valid_entry(backend, kernel, ent), key
        assert all(autotune.bucket(v) == v for v in bd.values()), key
        assert ent["us"] <= ent["static_us"] or \
            ent["tiles"] == autotune.static_tiles(kernel, metric, bd), key
    keys = set(entries)
    for kernel, metric, dims in autotune._WARM_FULL:
        bd = {k: autotune.bucket(v) for k, v in dims.items()}
        assert autotune._key("cuda-sm90", kernel, metric, bd) in keys


# ------------------------------------------------------- modes
def test_tiles_for_force_tunes_and_writes(tune_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    t = autotune.tiles_for("pdist", "sql2", _TINY)
    assert autotune._tiles_ok("pdist", t)
    data = json.loads(tune_cache.path.read_text())
    assert data["version"] == autotune.SCHEMA_VERSION
    [(key, ent)] = list(data["entries"].items())
    assert key.startswith(BACKEND + "/pdist/sql2/")
    assert ent["tiles"] == t
    # every time equal: the static tile is kept
    assert t == autotune.static_tiles("pdist", "sql2", {"q": 16})


def test_autotune_off_is_a_miss(tune_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    assert autotune.tiles_for("pdist", "sql2", _TINY) is None
    assert not tune_cache.path.exists()


def test_autotune_on_never_tunes_implicitly(tune_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    assert autotune.tiles_for("pdist", "sql2", _TINY) is None
    assert not tune_cache.path.exists()


def test_force_miss_inside_a_recording_takes_the_static_tile(
        tune_cache, monkeypatch):
    """A CUDA graph's warm-up or capture never tunes."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    with _cuda.recording():
        assert autotune.tiles_for("pdist", "sql2", _TINY) is None
    assert not tune_cache.path.exists()


def test_corrupted_cache_rejected_then_retuned(tune_cache, monkeypatch):
    bd = {k: autotune.bucket(v) for k, v in _TINY.items()}
    key = autotune._key(BACKEND, "pdist", "sql2", bd)
    v = autotune.SCHEMA_VERSION
    corrupt = {
        key: {"tiles": {"bq": 12, "bp": 64, "qb": 8}, "us": 1.0, "v": v},
        key + "x": {"tiles": {"bq": 8}, "us": 1.0, "v": v},       # names
        autotune._key(BACKEND, "rankeval", None, {"g": 8, "b": 8, "c": 8}):
            {"tiles": {"bb": "all"}, "us": 1.0, "v": v},           # type
        autotune._key(BACKEND, "range_filter", "sql2", bd):
            {"tiles": {"bq": 8, "bp": 512, "qb": 8}, "us": 1.0,
             "v": v + 1},                                        # schema
    }
    tune_cache.path.write_text(json.dumps(
        {"version": autotune.SCHEMA_VERSION, "entries": corrupt}))
    autotune._reset()
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    assert autotune.tiles_for("pdist", "sql2", _TINY) is None
    assert autotune.tiles_for("range_filter", "sql2", _TINY) is None
    tune_cache.timings[(("bp", 256), ("bq", 16), ("qb", 16))] = 50.0
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    t = autotune.tiles_for("pdist", "sql2", _TINY)
    assert t == {"bq": 16, "bp": 256, "qb": 16}
    data = json.loads(tune_cache.path.read_text())
    assert data["entries"][key]["tiles"] == t
    assert autotune._valid_entry(BACKEND, "pdist", data["entries"][key])
    autotune._reset()
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    assert autotune.tiles_for("pdist", "sql2", _TINY) == t


def test_truncated_cache_file_is_a_miss(tune_cache, monkeypatch):
    tune_cache.path.write_text('{"version": 1, "entr')      # torn write
    autotune._reset()
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    assert autotune.tiles_for("pdist", "sql2", _TINY) is None


def test_user_cache_overlays_shipped_defaults(tune_cache, monkeypatch,
                                              tmp_path):
    bd = {k: autotune.bucket(v) for k, v in _TINY.items()}
    key = autotune._key(BACKEND, "pdist", "sql2", bd)
    other = autotune._key(BACKEND, "rankeval", None,
                          {"g": 8, "b": 8, "c": 8})
    v = autotune.SCHEMA_VERSION
    shipped = tmp_path / "defaults.json"
    shipped.write_text(json.dumps({"version": v, "entries": {
        key: {"tiles": {"bq": 16, "bp": 1024, "qb": 16}, "us": 1.0, "v": v},
        other: {"tiles": {"bb": 2048}, "us": 1.0, "v": v}}}))
    tune_cache.path.write_text(json.dumps({"version": v, "entries": {
        key: {"tiles": {"bq": 8, "bp": 128, "qb": 8}, "us": 1.0, "v": v}}}))
    monkeypatch.setattr(autotune, "_DEFAULTS_PATH", shipped)
    autotune._reset()
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    assert autotune.tiles_for("pdist", "sql2", _TINY) == \
        {"bq": 8, "bp": 128, "qb": 8}
    assert autotune.tiles_for("rankeval", None,
                              {"g": 5, "b": 3, "c": 7}) == {"bb": 2048}


def _one_entry_cache(tune_cache, monkeypatch, tmp_path, tiles):
    """A user cache holding one pdist entry at ``_TINY``'s bucket with
    ``tiles``, no shipped defaults; the table reloaded under ``on``."""
    bd = {k: autotune.bucket(v) for k, v in _TINY.items()}
    v = autotune.SCHEMA_VERSION
    tune_cache.path.write_text(json.dumps({"version": v, "entries": {
        autotune._key(BACKEND, "pdist", "sql2", bd):
            {"tiles": tiles, "us": 1.0, "v": v}}}))
    monkeypatch.setattr(autotune, "_DEFAULTS_PATH", tmp_path / "none.json")
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    autotune._reset()


def test_on_answers_at_once_where_no_entry_changes_a_launch(
        tune_cache, monkeypatch, tmp_path):
    """A table whose entries all hold the static tile (the shipped one
    on an H100) changes no launch: under ``on`` every lookup answers
    None before it takes the lock or builds a key; ``force`` still
    reads the entry and tunes nothing."""
    static = autotune.static_tiles("pdist", "sql2", _TINY)
    _one_entry_cache(tune_cache, monkeypatch, tmp_path, static)
    assert autotune.tiles_for("pdist", "sql2", _TINY) is None
    assert autotune._live == {}
    before = tune_cache.path.read_text()
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    assert autotune.tiles_for("pdist", "sql2", _TINY) == static
    assert tune_cache.path.read_text() == before

    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock taken on the launch path")

        def __exit__(self, *exc):
            return False

    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    with monkeypatch.context() as mp:
        mp.setattr(autotune, "_lock", NoLock())
        mp.setattr(autotune, "_key", None)
        assert autotune.tiles_for("pdist", "sql2", _TINY) is None
        assert autotune.tiles_for("rankeval", None,
                                  {"g": 8, "b": 8, "c": 8}) is None


def test_a_lookup_is_cached_by_its_dims_until_the_table_changes(
        tune_cache, monkeypatch, tmp_path):
    tiles = {"bq": 16, "bp": 128, "qb": 16}
    _one_entry_cache(tune_cache, monkeypatch, tmp_path, tiles)
    first = autotune.tiles_for("pdist", "sql2", _TINY)
    assert first == tiles and autotune._live == {BACKEND: 1}
    assert autotune.tiles_for("pdist", "sql2", _TINY) is first
    # another call in the same bucket resolves to the same entry
    assert autotune.tiles_for("pdist", "sql2",
                              {"q": 15, "p": 60, "d": 7}) == tiles
    tune_cache.timings[(("bb", 512),)] = 50.0
    autotune.tune("rankeval", None, {"g": 8, "b": 8, "c": 8})
    assert autotune._RESOLVED == {} and autotune._live == {BACKEND: 2}
    assert autotune.tiles_for("rankeval", None,
                              {"g": 5, "b": 6, "c": 7}) == {"bb": 512}


def test_noise_margin_keeps_the_static_tile(tune_cache):
    """A grid winner within 3% of the static tile is not taken; one
    beyond it is."""
    static = autotune.static_tiles("rankeval", None, {})
    tune_cache.timings[_tile_key(static)] = 100.0
    tune_cache.timings[(("bb", 2048),)] = 97.5
    ent = autotune.tune("rankeval", None, {"g": 8, "b": 8, "c": 8})
    assert ent["tiles"] == static and ent["us"] == ent["static_us"] == 100.0
    tune_cache.timings[(("bb", 2048),)] = 96.5
    ent = autotune.tune("rankeval", None, {"g": 8, "b": 8, "c": 8})
    assert ent["tiles"] == {"bb": 2048}
    assert (ent["us"], ent["static_us"]) == (96.5, 100.0)


def test_revalidate_retunes_a_stale_entry(tune_cache):
    dims = {"g": 8, "b": 8, "c": 8}
    static = autotune.static_tiles("rankeval", None, dims)
    tune_cache.timings[_tile_key(static)] = 100.0
    tune_cache.timings[(("bb", 512),)] = 50.0
    assert autotune.tune("rankeval", None, dims)["tiles"] == {"bb": 512}
    # still winning: the timings are refreshed, the tile kept
    tune_cache.timings[(("bb", 512),)] = 60.0
    [(key, ent)] = autotune.revalidate().items()
    assert ent["tiles"] == {"bb": 512} and ent["us"] == 60.0
    # the win is gone: retuned from scratch, the static tile back
    tune_cache.timings[(("bb", 512),)] = 99.0
    [(key2, ent)] = autotune.revalidate().items()
    assert key2 == key and ent["tiles"] == static
    data = json.loads(tune_cache.path.read_text())
    assert data["entries"][key]["tiles"] == static
    assert autotune.revalidate() == {}       # static entries never stale


def test_tune_refuses_a_tile_whose_outputs_differ(tune_cache, monkeypatch):
    class Bench:
        def __init__(self, *a):
            pass

        def call(self, tiles):
            out = torch.tensor([float(tiles["bb"] == 512)])
            return lambda: out

        def plain(self):
            return torch.tensor([0.0])

    monkeypatch.setattr(autotune, "_Bench", Bench)
    with pytest.raises(RuntimeError, match="512"):
        autotune.tune("rankeval", None, {"g": 8, "b": 8, "c": 8})


def test_same_outputs_is_bitwise_with_nan():
    a = torch.tensor([1.0, float("nan"), -0.0])
    assert autotune.same_outputs((a,), (a.clone(),))
    assert not autotune.same_outputs((a,), (torch.tensor([1.0, 2.0, 0.0]),))
    assert not autotune.same_outputs((a,), (a.double(),))


def test_ops_reads_no_table_for_cpu_tensors(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tiles_for read for a CPU tensor")

    monkeypatch.setattr(autotune, "tiles_for", boom)
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    ops.pdist(q, p)
    ops.pdist(q, p.to(torch.bfloat16))
    ops.range_filter(q, p, torch.ones(5))
    g = torch.ones(4, 9)
    ops.rankeval(torch.rand(4, 7), g, torch.zeros(4), torch.ones(4),
                 torch.full((4,), 10.0))
    ops.pdist_rankeval(q, p[:4], g, torch.zeros(4), torch.ones(4),
                       torch.full((4,), 10.0), torch.ones(5))


# ------------------------------------------------------------ env
def test_env_describe_names_every_knob():
    text = env.describe()
    for name in env.KNOBS:
        assert name in text
    for name in ("REPRO_AUTOTUNE", "REPRO_TUNE_CACHE"):
        assert name in text


def test_env_autotune_knob_values(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert env.get("REPRO_AUTOTUNE") == "on"
    monkeypatch.setenv("REPRO_AUTOTUNE", "FORCE")
    assert env.get("REPRO_AUTOTUNE") == "force"
    monkeypatch.setenv("REPRO_AUTOTUNE", "sometimes")
    with pytest.raises(ValueError, match="force"):
        env.get("REPRO_AUTOTUNE")
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/some/where.json")
    assert str(autotune.cache_path()) == "/some/where.json"
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    assert autotune.cache_path().name == "repro-torch-tune.json"


# --------------------------------------------------------------- gpu
ODD = (np.nan, np.inf, -np.inf, 1e30, -1e30)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _stream_call(kernel, metric, q, p, r2, tiles):
    from repro_torch.kernels import pdist as pd
    from repro_torch.kernels import range_filter as rf
    if kernel.startswith("range_filter"):
        return (rf.range_filter_cuda(q, p, r2, tiles),
                range_filter_plain(q, p, r2))
    name, plain = METRICS[metric]
    return pd.pdist_cuda(q, p, name, tiles), plain(q, p)


STREAM_CASES = [(k, m, nq, npts, d)
                for k, m in (("pdist", "sql2"), ("pdist", "l1"),
                             ("pdist", "linf"), ("pdist_bf16", "sql2"),
                             ("pdist_f16", "sql2"), ("range_filter", "sql2"),
                             ("range_filter_bf16", "sql2"),
                             ("range_filter_f16", "sql2"))
                for nq, npts, d in ((1, 1, 8), (37, 1001, 8),
                                    (137, 4099, 8), (65, 257, 32),
                                    (200, 1003, 9), (9, 130, 784))]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,metric,nq,npts,d", STREAM_CASES)
def test_every_stream_tile_matches_plain_on_card(kernel, metric, nq, npts, d):
    """Every candidate tile of a streaming kernel at its bucket, at
    ragged shapes, with a NaN point row and a FAR row: outputs bit-equal
    to the plain version (range_filter: mask and counts)."""
    dev = _card()
    rng = np.random.default_rng(nq + npts + d)
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32))
    p = rng.normal(size=(npts, d)).astype(np.float32)
    if npts >= 3:
        p[npts // 2, d // 2] = np.nan
        p[npts - 2] = ops.FAR
    suffix = kernel.rsplit("_", 1)[1] if kernel.endswith(("bf16", "f16")) \
        else ""
    ptype = {"": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[suffix]
    q, p = q.to(dev), torch.from_numpy(p).to(dev).to(ptype)
    r2 = torch.from_numpy(rng.uniform(0.5, 3.0, nq).astype(np.float32)
                          * d).to(dev)
    bd = {"q": autotune.bucket(nq), "p": autotune.bucket(npts),
          "d": autotune.bucket(d)}
    cands = autotune._candidates(kernel, metric, bd)
    assert len(cands) > 1
    for tiles in cands:
        got, want = _stream_call(kernel, metric, q, p, r2, tiles)
        assert autotune.same_outputs(got, want), tiles
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("G,B,C", [(1, 1, 9), (13, 1001, 9), (5, 4099, 16),
                                   (7, 3001, 21), (192, 2000, 9)])
def test_every_rankeval_tile_matches_plain_on_card(G, B, C):
    dev = _card()
    rng = np.random.default_rng(G + B + C)
    x = rng.uniform(0.0, 2.0, (G, B)).astype(np.float32)
    cells = rng.choice(G * B, size=min(G * B, 32), replace=False)
    x.flat[cells] = np.resize(ODD, len(cells))
    coef = (rng.normal(size=(G, C)) * 10).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in
            (x, coef, np.zeros(G, np.float32), np.full(G, 2.0, np.float32),
             np.full(G, 500.0, np.float32))]
    from repro_torch.kernels import rankeval as re_mod
    want = rank_math_plain(*args, 20)
    for tiles in autotune._candidates("rankeval", None, {}):
        assert autotune.same_outputs(re_mod.rankeval_cuda(*args, 20, tiles),
                                     want), tiles
    # and x 4 bytes off the 16-B grid (the value-by-value path)
    xo = torch.empty(G * B + 1, device=dev)[1:].view(G, B)
    xo.copy_(args[0])
    want = rank_math_plain(xo, *args[1:], 20)
    for tiles in autotune._candidates("rankeval", None, {}):
        assert autotune.same_outputs(
            re_mod.rankeval_cuda(xo, *args[1:], 20, tiles), want), tiles


@pytest.mark.gpu
@pytest.mark.parametrize("B,G,d,C", [(1, 1, 8, 9), (37, 19, 8, 9),
                                     (64, 192, 8, 9), (65, 33, 9, 21),
                                     (137, 301, 8, 16)])
def test_every_fused_tile_matches_plain_on_card(B, G, d, C):
    dev = _card()
    rng = np.random.default_rng(B + G + d + C)
    q = rng.normal(size=(B, d)).astype(np.float32)
    if B > 2:
        q[B // 2, 0] = np.nan
        q[1] = 1e30
    args = [torch.from_numpy(a).to(dev) for a in
            (q, rng.normal(size=(G, d)).astype(np.float32),
             (rng.normal(size=(G, C)) * 10).astype(np.float32),
             np.zeros(G, np.float32), np.full(G, 8.0, np.float32),
             np.full(G, 500.0, np.float32),
             np.abs(rng.normal(size=B)).astype(np.float32))]
    from repro_torch.kernels import fused
    want = pdist_rankeval_plain(*args, 20)
    for tiles in autotune._candidates("pdist_rankeval", None, {}):
        assert autotune.same_outputs(
            fused.pdist_rankeval_cuda(*args, 20, tiles), want), tiles


@pytest.mark.gpu
def test_tuned_tiles_change_grid_not_values_on_card(tmp_path, monkeypatch):
    """Tune three small buckets on the card (force), then run the ops
    wrappers with the table on and off: identical outputs; the entries
    landed in the cache with their tiles and times."""
    dev = _card()
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    autotune._reset()
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).to(dev)
    p = torch.from_numpy(rng.normal(size=(4000, 8)).astype(np.float32)).to(
        dev)
    r = torch.full((16,), 3.0, device=dev)
    try:
        monkeypatch.setenv("REPRO_AUTOTUNE", "force")
        a = (ops.pdist(q, p), *ops.range_filter(q, p, r),
             *ops.pdist(q, p.to(torch.bfloat16)).unsqueeze(0))
        data = json.loads((tmp_path / "tune.json").read_text())
        assert len(data["entries"]) == 3
        for key, ent in data["entries"].items():
            assert key.startswith(autotune.backend_key(dev) + "/")
            assert ent["us"] > 0 and ent["static_us"] > 0
        monkeypatch.setenv("REPRO_AUTOTUNE", "off")
        b = (ops.pdist(q, p), *ops.range_filter(q, p, r),
             *ops.pdist(q, p.to(torch.bfloat16)).unsqueeze(0))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    finally:
        autotune._reset()


def test_point_type_suffixes_are_the_launch_names():
    for t, suffix in POINT_TYPES.items():
        assert autotune._POINT_TYPES[suffix.lstrip("_")] == t
        assert f"pdist{suffix}" in _cuda.SOURCES
        assert f"range_filter{suffix}" in _cuda.SOURCES
