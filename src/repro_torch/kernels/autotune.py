"""Per-card kernel tile autotuner with a persistent tuning table.

Port of ``repro/kernels/autotune.py``.  Each query kernel's CUDA launch
takes a tile from a small set (``csrc/stream.cuh``, ``rankeval.cu``,
``fused.cu``); its static tile is the one every launch took before the
tile was a parameter.  This module replaces the static tile with a
measured table where it has an entry:

* **Key**: ``backend/kernel/metric/dim=bucket…``.  ``backend`` is
  :func:`backend_key`, the card's architecture (``cuda-sm90`` on an
  H100), never the reference's ``gpu``: an entry written for Pallas
  tiles is never read as the port's.  ``kernel`` is the launched
  kernel's name as ``_cuda.LAUNCHES`` counts it (``pdist_bf16`` is the
  sql2 body on bf16 points).  Every operand dimension is bucketed to the
  next power of two (floor 8), so one entry covers a shape bucket.
* **Value**: ``{"tiles": {...}, "us": best, "static_us": static,
  "v": 1}``; ``us`` is device microseconds a launch (CUDA events around
  replays of a CUDA graph of bare launches at the bucket shape).
* **Tiles** (``_TILE_NAMES`` and ``_valid_entry`` are the contract):

  - ``pdist``, ``range_filter`` and their bf16 / f16 bodies:
    ``bp`` points a block (threads x 4: 128, 256, 512 or 1,024, whole
    128-point count tiles of ``range_filter``), ``bq`` query rows a
    chunk (a multiple of 8 up to 128 and up to bp / 4: one thread loads
    each row; the shared memory's cap also applies at run time) and
    ``qb`` = ``bq`` (the reference's query sub-block, pinned as its GPU
    lane pins it).  Static: bp 512, bq 64.
  - ``rankeval``: ``bb`` values a block (threads x 8: 512, 1,024 or
    2,048).  The reference's ``bg`` (groups a block) has no meaning
    here: a block is always one group's run of values.  Static: 1,024.
  - ``pdist_rankeval``: ``bb`` queries x ``bg`` groups a block, each 8
    or 16.  Static: 8 x 8.

  No output depends on the tile: every output is one thread's
  arithmetic on its own operands (a count tile one warp's), and
  :func:`tune` holds every candidate's outputs to the plain version's
  bit for bit before it may be timed.
* **Search**: each candidate timed (best of 3); the winner is then
  timed against the static tile in A/B/A/B turns and accepted only when
  it beats it by more than ``_NOISE_MARGIN`` (3%); otherwise the static
  tile is cached with its time.  :func:`revalidate` re-measures cached
  entries and retunes those whose win has gone.
* **Persistence**: the shipped defaults (``tuning_defaults.json`` beside
  this file, written by ``--warm`` on an H100) overlaid by a user cache
  (``~/.cache/repro-torch-tune.json`` or ``$REPRO_TUNE_CACHE``), written
  atomically (temp + rename).  Entries failing validation are dropped on
  load and retuned under ``force``.

``REPRO_AUTOTUNE`` controls consultation (``repro_torch.env``): ``off``
-> static tiles; ``on`` (default) -> table lookups, the static tile on a
miss, never tunes implicitly; ``force`` -> tune a miss now and write the
cache.  ``ops`` consults the table for CUDA tensors only: the plain
versions have no tiles, as the reference's interpret lane reads no
table.

Two hazards:

* No tuning inside a CUDA graph capture.  The kNN loop captures its
  round with the tiles the table gives at capture time
  (``core/executor.py``, ``_LOOP_GRAPHS``), and a tuning run would
  launch (and synchronise) inside the capture.  Under ``force`` a miss
  while ``_cuda.recording()`` is open (a graph's warm-up or capture)
  takes the static tile.
* The table is read from the frontend's sub-batch threads: every read
  and write of it is under ``_lock``.

Usage: ``python -m repro_torch.kernels.autotune --warm [--quick]
[--revalidate]`` on the card.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
from pathlib import Path

import torch

from .. import env
from . import _cuda
from . import fused as _fused
from . import pdist as _pdist
from . import rankeval as _rankeval
from . import range_filter as _range_filter

SCHEMA_VERSION = 1
_DEFAULTS_PATH = Path(__file__).parent / "tuning_defaults.json"

# tuned entries must beat the static tile by this fraction on a paired
# best-of-3 to be accepted (and to survive revalidation)
_NOISE_MARGIN = 0.03

_lock = threading.RLock()
_table: dict[str, dict] | None = None
# backend -> how many of its entries hold a tile other than the static
# one; a backend absent here has no entry that changes a launch
_live: dict[str, int] | None = None

_STREAM = ("pdist", "pdist_bf16", "pdist_f16", "range_filter",
           "range_filter_bf16", "range_filter_f16")
# each launched kernel's module: its STATIC_TILES and tile_args (the
# tile ints its launch takes last, in their order)
_MODULES = {**{k: _pdist for k in _STREAM + ("pdist_l1", "pdist_linf")},
            "rankeval": _rankeval, "pdist_rankeval": _fused}
# tile-name sets per kernel (also the validation contract)
_TILE_NAMES = {**{k: ("bq", "bp", "qb") for k in _STREAM},
               "rankeval": ("bb",),
               "pdist_rankeval": ("bg", "bb")}
_BP = (128, 256, 512, 1024)             # stream.cuh's with_threads
_BQ = (16, 32, 64, 128)                 # query rows a chunk
_BQ_MAX = 128
_RANK_BB = (512, 1024, 2048)            # rankeval.cu's launch_bb
_FUSED_B = (8, 16)                      # fused.cu's launch_tile, each side

# a 2-byte body's point type by its kernel name's suffix
_POINT_TYPES = {"": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}

# backend_key by device index; a lookup's answer by (backend, kernel,
# metric, the call's dims), at most _RESOLVED_CAP (shapes that vary call
# to call clear it now and then; every change of the table clears it)
_BACKENDS: dict[int, str] = {}
_RESOLVED: dict[tuple, object] = {}
_RESOLVED_CAP = 4096
_ABSENT = object()      # _RESOLVED's value for a bucket with no entry


def mode() -> str:
    return env.get("REPRO_AUTOTUNE")


def cache_path() -> Path:
    p = env.get("REPRO_TUNE_CACHE")
    if p:
        return Path(p)
    return Path(os.path.expanduser("~")) / ".cache" / "repro-torch-tune.json"


def backend_key(device=None) -> str:
    """``cuda-sm<major><minor>`` of ``device`` (default: the current
    card).  Raises ``RuntimeError`` where there is no card."""
    dev = device if isinstance(device, torch.device) \
        else torch.device("cuda" if device is None else device)
    index = dev.index
    if index is None:
        _card()
        index = torch.cuda.current_device()
    key = _BACKENDS.get(index)          # the launch path: one dict read
    if key is None:
        _card()
        major, minor = torch.cuda.get_device_capability(index)
        key = _BACKENDS[index] = f"cuda-sm{major}{minor}"
    return key


def _card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tuning table keys a card")


def bucket(n: int) -> int:
    """Next power of two, floor 8 — the shape-bucketing of table keys."""
    return max(8, 1 << (int(max(n, 1)) - 1).bit_length())


def _key(backend: str, kernel: str, metric: str | None,
         bdims: dict[str, int]) -> str:
    dims = "/".join(f"{k}={v}" for k, v in sorted(bdims.items()))
    return f"{backend}/{kernel}/{metric or '-'}/{dims}"


def _tiles_ok(kernel: str, tiles: dict[str, int]) -> bool:
    """The port's alignment rules for one kernel's tile."""
    if kernel in _STREAM:
        bq, bp = tiles["bq"], tiles["bp"]
        return (bp in _BP and bq % 8 == 0 and 8 <= bq <= min(_BQ_MAX,
                                                            bp // 4)
                and tiles["qb"] == bq)
    if kernel == "rankeval":
        return tiles["bb"] in _RANK_BB
    return tiles["bb"] in _FUSED_B and tiles["bg"] in _FUSED_B


def _valid_entry(backend: str, kernel: str, ent) -> bool:
    if not backend.startswith("cuda-"):
        return False            # never another package's or lane's tiles
    if not isinstance(ent, dict) or ent.get("v") != SCHEMA_VERSION:
        return False
    tiles = ent.get("tiles")
    names = _TILE_NAMES.get(kernel)
    if names is None or not isinstance(tiles, dict):
        return False
    if set(tiles) != set(names):
        return False
    if not all(isinstance(t, int) and not isinstance(t, bool) and t > 0
               for t in tiles.values()):
        return False
    if not _tiles_ok(kernel, tiles):
        return False
    return isinstance(ent.get("us"), (int, float))


def _load_file(path: Path) -> dict[str, dict]:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(data, dict):
        return {}
    entries = data.get("entries")
    return entries if isinstance(entries, dict) else {}


def _entries() -> dict[str, dict]:
    """Validated merged table (shipped defaults overlaid by user cache)."""
    global _table
    with _lock:
        if _table is None:
            merged: dict[str, dict] = {}
            for path in (_DEFAULTS_PATH, cache_path()):
                for key, ent in _load_file(path).items():
                    parts = key.split("/")
                    if len(parts) < 3:
                        continue
                    if _valid_entry(parts[0], parts[1], ent):
                        merged[key] = ent
            _table = merged
            _changed()
        return _table


def _changed() -> None:
    """After any change of ``_table`` (under ``_lock``): recount each
    backend's entries that change a launch, drop the cached answers."""
    global _live
    live: dict[str, int] = {}
    for key, ent in _table.items():
        if not _is_static(key, ent):
            backend = key.split("/")[0]
            live[backend] = live.get(backend, 0) + 1
    _RESOLVED.clear()
    _live = live


def _is_static(key: str, ent: dict) -> bool:
    """Whether ``ent`` holds its bucket's static tile (a key without the
    dims that decide it counts as not)."""
    parsed = _parse_key(key)
    try:
        return parsed is not None and \
            ent["tiles"] == static_tiles(*parsed[1:])
    except (KeyError, ValueError):
        return False


def _put(key: str, ent: dict) -> None:
    """Enter ``ent`` in the table and the user cache."""
    with _lock:
        _entries()[key] = ent
        _write_user_cache(key, ent)
        _changed()


def _reset() -> None:
    """Drop the in-memory table (tests re-point REPRO_TUNE_CACHE)."""
    global _table, _live
    with _lock:
        _table, _live = None, None
        _RESOLVED.clear()


def tiles_for(kernel: str, metric: str | None, dims: dict[str, int],
              device=None) -> dict[str, int] | None:
    """Tuned tiles for this launch on ``device``'s card, or None -> the
    kernel's static tile.  The dict returned is shared: read it only.

    Looks up the (backend, kernel, metric, shape-bucket) entry; under
    ``REPRO_AUTOTUNE=force`` a miss (or an entry invalidated on load) is
    tuned on the spot and cached, except inside a CUDA graph's warm-up or
    capture (``_cuda.recording()``, or any stream capture), where it
    takes the static tile.

    Every CUDA launch of a query kernel asks, so under ``on`` a card
    whose entries all hold the static tile (the shipped table on an
    H100) answers None at once: no lock, no key, no copy.  Otherwise the
    answer is cached by the call's exact dims.
    """
    m = mode()
    if m == "off":
        return None
    backend = backend_key(device)
    live = _live
    if live is None:
        _entries()
        live = _live
    if m == "on" and backend not in live:
        return None
    ck = (backend, kernel, metric, tuple(dims.items()))
    tiles = _RESOLVED.get(ck)
    if tiles is None:
        key = _key(backend, kernel, metric,
                   {k: bucket(v) for k, v in dims.items()})
        with _lock:
            ent = _entries().get(key)
            tiles = _ABSENT if ent is None else dict(ent["tiles"])
            if len(_RESOLVED) >= _RESOLVED_CAP:
                _RESOLVED.clear()
            _RESOLVED[ck] = tiles
    if tiles is not _ABSENT:
        return tiles
    capturing = torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()
    if m == "force" and _cuda.current_recording() is None and not capturing:
        return dict(tune(kernel, metric, dims, device=device)["tiles"])
    return None


def tile_args(kernel: str, tiles: dict[str, int] | None = None) -> tuple:
    """The tile ints a bare launch of ``kernel`` takes last, in their
    order (its module's ``tile_args``); the static tile if None."""
    return _MODULES[kernel].tile_args(tiles)


def static_tiles(kernel: str, metric: str | None,
                 dims: dict[str, int]) -> dict[str, int]:
    """The static tile at ``dims``, the tuner's baseline candidate (it
    never consults the table).  A streaming kernel's ``bq`` is clamped
    to the query bucket: a chunk of at least the launch's rows is one
    chunk either way, so the clamp changes no launch."""
    if kernel not in _TILE_NAMES:
        raise ValueError(f"unknown kernel {kernel!r}")
    static = dict(_MODULES[kernel].STATIC_TILES)
    if kernel in _STREAM:
        static["bq"] = static["qb"] = min(static["bq"], bucket(dims["q"]))
    return static


# ---------------------------------------------------------------- tuning

def _candidates(kernel: str, metric: str | None,
                bd: dict[str, int]) -> list[dict[str, int]]:
    """The candidate grid; always contains the static tile, so "tuned"
    can only tie or beat it on the measurements."""
    if kernel in _STREAM:
        cands = [{"bq": min(bq, bd["q"]), "bp": bp, "qb": min(bq, bd["q"])}
                 for bp in _BP for bq in _BQ if bq <= bp // 4]
    elif kernel == "rankeval":
        cands = [{"bb": bb} for bb in _RANK_BB]
    elif kernel == "pdist_rankeval":
        cands = [{"bg": bg, "bb": bb} for bg in _FUSED_B for bb in _FUSED_B]
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    cands.append(static_tiles(kernel, metric, bd))
    seen, out = set(), []
    for c in sorted(cands, key=lambda c: sorted(c.items())):
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


class _Bench:
    """One kernel at a bucket shape on the card: seeded operands, a call
    of its CUDA function at given tiles, and the plain version's
    outputs.  The calls bypass ``ops`` and the table, so tuning never
    recurses into a lookup."""

    def __init__(self, kernel: str, metric: str | None, bd: dict[str, int],
                 device):
        dev = torch.device("cuda" if device is None else device)
        gen = torch.Generator(device=dev).manual_seed(0)

        def normal(*shape, dtype=torch.float32):
            return torch.randn(*shape, generator=gen, device=dev).to(dtype)

        self.kernel, self.metric = kernel, metric
        if kernel in _STREAM:
            suffix = kernel.rsplit("_", 1)[1] \
                if kernel.endswith(("_bf16", "_f16")) else ""
            ptype = _POINT_TYPES[suffix]
            self.args = (normal(bd["q"], bd["d"]),
                         normal(bd["p"], bd["d"], dtype=ptype))
            if kernel.startswith("range_filter"):
                # radii around the median distance: masks half full
                self.args += (torch.full((bd["q"],), 2.0 * bd["d"],
                                         device=dev),)
        else:
            g, c = bd["g"], bd["c"]
            coef = normal(g, c) * 10.0
            lo = torch.zeros(g, device=dev)
            hi = torch.full((g,), 2.0 * math.sqrt(bd.get("d", 1)),
                            device=dev)
            n = torch.full((g,), 1000.0, device=dev)
            if kernel == "rankeval":
                x = normal(g, bd["b"]).abs()
                self.args = (x, coef, lo, hi, n)
            else:
                self.args = (normal(bd["b"], bd["d"]), normal(g, bd["d"]),
                             coef, lo, hi, n,
                             torch.full((bd["b"],), 0.5, device=dev))

    def call(self, tiles: dict[str, int]):
        """A zero-argument callable: one launch at ``tiles``."""
        a, k = self.args, self.kernel
        if k.startswith("pdist_rankeval"):
            return lambda: _fused.pdist_rankeval_cuda(*a, 20, tiles)
        if k == "rankeval":
            return lambda: _rankeval.rankeval_cuda(*a, 20, tiles)
        if k.startswith("range_filter"):
            return lambda: _range_filter.range_filter_cuda(*a, tiles)
        name = _pdist.METRICS[self.metric or "sql2"][0]
        return lambda: _pdist.pdist_cuda(*a, name, tiles)

    def plain(self):
        a, k = self.args, self.kernel
        if k == "pdist_rankeval":
            return _fused.pdist_rankeval_plain(*a, 20)
        if k == "rankeval":
            return _rankeval.rank_math_plain(*a, 20)
        if k.startswith("range_filter"):
            return _range_filter.range_filter_plain(*a)
        return _pdist.METRICS[self.metric or "sql2"][1](*a)


def _outputs(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def same_outputs(got, want) -> bool:
    """Bit for bit equal, NaN where the other is NaN."""
    for a, b in zip(_outputs(got), _outputs(want), strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            na, nb = torch.isnan(a), torch.isnan(b)
            if not torch.equal(na, nb):
                return False
            a, b = torch.where(na, 0, a), torch.where(nb, 0, b)
        if not torch.equal(a, b):
            return False
    return True


def _graph(thunk, window_us: float = 1000.0):
    """``thunk`` warmed, then ``n`` calls captured in one CUDA graph,
    ``n`` sized so a replay takes about ``window_us``: (graph, n)."""
    thunk()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    thunk()
    end.record()
    end.synchronize()
    one_us = max(start.elapsed_time(end) * 1e3, 1.0)
    n = max(1, min(100, math.ceil(window_us / one_us)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            thunk()
    graph.replay()
    torch.cuda.synchronize()
    return graph, n


def _replay_us(graph, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def _time_us(thunk, reps: int = 3) -> float:
    """Device microseconds a call of ``thunk`` (bare launches): best of
    ``reps`` replays of a CUDA graph of them, CUDA events around each —
    no host cost in the window (a wrapper's ~37 us host path would hide
    a 3 us kernel)."""
    graph, n = _graph(thunk)
    return min(_replay_us(graph, n) for _ in range(reps))


def _paired_us(thunk_a, thunk_b, reps: int = 3) -> tuple[float, float]:
    """Interleaved best-of-``reps`` device times of two thunks' graphs
    (A/B/A/B/…), so drift on the card hits both measurements equally —
    the comparison the acceptance margin is applied to."""
    ga, na = _graph(thunk_a)
    gb, nb = _graph(thunk_b)
    best_a = best_b = float("inf")
    for _ in range(reps):
        best_a = min(best_a, _replay_us(ga, na))
        best_b = min(best_b, _replay_us(gb, nb))
    return best_a, best_b


def tune(kernel: str, metric: str | None, dims: dict[str, int],
         verbose: bool = False, device=None) -> dict:
    """Search the candidate grid for this shape bucket on ``device``'s
    card, persist and return the winning entry.

    Every candidate's outputs must equal the plain version's bit for bit
    (``RuntimeError`` otherwise).  The grid winner is accepted only when
    a *paired* best-of-3 against the static tile shows it faster by more
    than ``_NOISE_MARGIN``; otherwise the static tile is cached with its
    measured time.  The launches are kept out of ``_cuda.LAUNCHES``."""
    backend = backend_key(device)
    bd = {k: bucket(v) for k, v in dims.items()}
    key = _key(backend, kernel, metric, bd)
    static = static_tiles(kernel, metric, bd)
    bench = _Bench(kernel, metric, bd, device)
    with _cuda.recording():
        want = bench.plain()
        best_tiles, best_us = None, float("inf")
        for tiles in _candidates(kernel, metric, bd):
            call = bench.call(tiles)
            if not same_outputs(call(), want):
                raise RuntimeError(f"{key}: tile {tiles} gives outputs "
                                   "other than the plain version's")
            us = _time_us(call)
            if verbose:
                print(f"  {key} {tiles} -> {us:.2f}us (bit-equal to plain)")
            if us < best_us:
                best_tiles, best_us = tiles, us
        del want
        static_us = best_us
        if best_tiles != static:
            best_us, static_us = _paired_us(bench.call(best_tiles),
                                            bench.call(static))
            if best_us >= static_us * (1.0 - _NOISE_MARGIN):
                best_tiles, best_us = dict(static), static_us
                if verbose:
                    print(f"  {key} grid winner within noise of static "
                          f"-> keeping static {static}")
    ent = {"tiles": best_tiles, "us": round(best_us, 3),
           "static_us": round(static_us, 3), "v": SCHEMA_VERSION}
    _put(key, ent)
    return ent


def _parse_key(key: str):
    """(backend, kernel, metric, bucket-dims) from a table key, or None
    when malformed."""
    parts = key.split("/")
    if len(parts) < 4:
        return None
    backend, kernel, metric = parts[0], parts[1], parts[2]
    try:
        dims = {k: int(v) for k, v in (s.split("=") for s in parts[3:])}
    except ValueError:
        return None
    return backend, kernel, None if metric == "-" else metric, dims


def revalidate(verbose: bool = False, device=None) -> dict:
    """Re-measure every cached entry for this card.

    Entries whose tiles no longer beat the static tile by the noise
    margin are re-tuned from scratch; still-winning entries get their
    timings refreshed.  Returns {key: entry} for every entry touched."""
    backend = backend_key(device)
    out = {}
    for key, ent in sorted(_entries().items()):
        parsed = _parse_key(key)
        if parsed is None or parsed[0] != backend:
            continue
        _, kernel, metric, bd = parsed
        static = static_tiles(kernel, metric, bd)
        if ent["tiles"] == static:
            continue                      # static entries can't go stale
        bench = _Bench(kernel, metric, bd, device)
        with _cuda.recording():
            tuned_us, static_us = _paired_us(bench.call(ent["tiles"]),
                                             bench.call(static))
        if tuned_us >= static_us * (1.0 - _NOISE_MARGIN):
            if verbose:
                print(f"  {key}: stale ({tuned_us:.2f}us vs static "
                      f"{static_us:.2f}us) -> retuning")
            out[key] = tune(kernel, metric, bd, verbose=verbose,
                            device=device)
        else:
            new = {"tiles": dict(ent["tiles"]), "us": round(tuned_us, 3),
                   "static_us": round(static_us, 3), "v": SCHEMA_VERSION}
            _put(key, new)
            out[key] = new
    return out


def _write_user_cache(key: str, ent: dict) -> None:
    path = cache_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    entries = _load_file(path)
    entries[key] = ent
    payload = {"version": SCHEMA_VERSION, "entries": entries}
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ------------------------------------------------------------------ warm

# the buckets the main path launches (chip_smoke.py's main: 64-query
# batches over n = 1,000,000 GaussMix rows, d 8, K 64 x m 3 pivots):
# pdist and range_filter over the 4,607,872 padded slots, range_filter
# over a compacted bucket, pdist at the kNN seed's (64, 192), the plan
# stage at (64, 192) C 9, and rankeval's E certification (192, 71,998)
_WARM_MAIN = (
    ("pdist", "sql2", {"q": 64, "p": 4_607_872, "d": 8}),
    ("range_filter", "sql2", {"q": 64, "p": 4_607_872, "d": 8}),
    ("range_filter", "sql2", {"q": 64, "p": 1_048_576, "d": 8}),
    ("pdist_rankeval", None, {"g": 192, "b": 64, "d": 8, "c": 9}),
    ("rankeval", None, {"g": 192, "b": 71_998, "c": 9}),
)
# the standard buckets: the reference's (its bench_kernels shapes and
# the serving refinement bucket), main's, the kNN seed's pdist and the
# 2-byte filter plane's launches at main's shapes
_WARM_FULL = (
    ("pdist", "sql2", {"q": 256, "p": 65536, "d": 32}),
    ("range_filter", "sql2", {"q": 256, "p": 65536, "d": 32}),
    ("pdist", "sql2", {"q": 64, "p": 92544, "d": 8}),
    ("range_filter", "sql2", {"q": 64, "p": 92544, "d": 8}),
    ("rankeval", None, {"g": 64, "b": 4096, "c": 16}),
    ("rankeval", None, {"g": 48, "b": 128, "c": 21}),
    ("pdist_rankeval", None, {"g": 64, "b": 256, "d": 32, "c": 16}),
    ("pdist_rankeval", None, {"g": 48, "b": 64, "d": 8, "c": 21}),
    *_WARM_MAIN,
    ("pdist", "sql2", {"q": 64, "p": 192, "d": 8}),
    *((f"{k}_{t}", "sql2", {"q": 64, "p": p, "d": 8})
      for t in ("bf16", "f16")
      for k, p in (("pdist", 4_607_872), ("range_filter", 4_607_872),
                   ("range_filter", 1_048_576))),
)
# small shapes, every kernel and body: the generic width (d 16), l1 /
# linf and the 2-byte point types
_WARM_QUICK = (
    ("pdist", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("pdist", "l1", {"q": 128, "p": 4096, "d": 16}),
    ("pdist", "linf", {"q": 128, "p": 4096, "d": 16}),
    ("pdist_bf16", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("pdist_f16", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("range_filter", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("range_filter_bf16", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("range_filter_f16", "sql2", {"q": 128, "p": 4096, "d": 16}),
    ("rankeval", None, {"g": 64, "b": 512, "c": 16}),
    ("pdist_rankeval", None, {"g": 64, "b": 128, "d": 16, "c": 16}),
)


def warm(shapes=None, quick: bool = False, verbose: bool = False,
         device=None) -> dict:
    """Tune (and cache) the standard shape buckets; returns {key:
    entry}.  Tunes unconditionally — the CLI entry point for cache
    warming on a card, regardless of REPRO_AUTOTUNE."""
    shapes = shapes if shapes is not None else (
        _WARM_QUICK if quick else _WARM_FULL)
    out = {}
    for kernel, metric, dims in shapes:
        ent = tune(kernel, metric, dims, verbose=verbose, device=device)
        bd = {k: bucket(v) for k, v in dims.items()}
        out[_key(backend_key(device), kernel, metric, bd)] = ent
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Warm the kernel tile tuning cache on this card.")
    ap.add_argument("--warm", action="store_true",
                    help="tune the standard shape buckets")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes, every kernel and body")
    ap.add_argument("--revalidate", action="store_true",
                    help="re-measure cached entries; retune stale ones "
                         "whose win over the static tile is gone")
    args = ap.parse_args(argv)
    if not (args.warm or args.revalidate):
        ap.print_help()
        return 2
    if not torch.cuda.is_available():
        print("autotune: no CUDA device is available", flush=True)
        return 2
    res = warm(quick=args.quick, verbose=True) if args.warm else {}
    if args.revalidate:
        res.update(revalidate(verbose=True))
    print(f"tuned {len(res)} entries -> {cache_path()}")
    for key, ent in res.items():
        print(f"  {key}: {ent['tiles']} ({ent['us']:.2f}us, "
              f"static {ent.get('static_us', ent['us']):.2f}us)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
