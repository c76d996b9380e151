"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each source in ``csrc/`` (one per kernel, or per family of kernels, as
``pdist_lp.cu`` holds ``pdist_l1`` and ``pdist_linf``) compiles on its
own into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -prec-div=true -prec-sqrt=true
         -o _build/<name>-<hash>.so csrc/<name>.cu

All sources compile in parallel, at the first launch of any kernel, into
``_build/`` beside this file (listed in ``.gitignore``); a library whose
sources and flags hash to an existing file is reused.  ``-fmad=false``
and the IEEE division and square root keep the kernels' f32 arithmetic
identical to the plain PyTorch versions' operation order (the sources
also spell every step with round-to-nearest intrinsics).

Every C entry point takes its pointers and the stream as ``void*`` and
returns the launch's ``cudaGetLastError()``; :func:`launch` makes the
operands' device current where another one is, passes that device's
current stream, raises on a nonzero code and otherwise counts the launch
in :data:`LAUNCHES` — or, on a thread inside :func:`recording` (a CUDA
graph's warm-up or capture, where the launch is not the one that runs),
in the recording's tally, which the graph's owner adds to
:data:`LAUNCHES` once per replay that ran it (:func:`add_launches`).
``graph_loop.cu`` holds no launch entry: its host functions
(:data:`HOST_FUNCS`, bound by :func:`host`) build, launch and destroy
the kNN loop's conditional CUDA graph, whose one-thread kernel
``knn_loop_cond`` runs only as a node of that graph.  The first launch
builds and binds every library under a lock, so threads that launch
their first kernels together (an async snapshot refresh beside a query
thread) build once and never see a half-bound table.  A
kernel with one entry point per operand type (``flash_attention_f32``
and ``flash_attention_bf16``, one template) names them in
:data:`VARIANTS`; its launches are counted under the kernel's name.
Nothing here is touched when a module is imported: the CPU tests import
every module on machines without nvcc or a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CUDA_ROOTS = ("/usr/local/cuda",)

# -Xptxas -v only reports: each kernel's registers, shared memory and
# spills land in the build's log (Built.log), and the code is the same
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (C symbol, argument types without the trailing stream)
# (the query kernels' last ints are their tile: pdist, range_filter and
# the l1 / linf bodies (bp, bq), rankeval bb, pdist_rankeval (bb, bg);
# kernels/autotune.py says what each means)
SIGNATURES: dict[str, tuple[str, tuple]] = {
    "pdist": ("pdist_sql2", (_P, _P, _P) + (_I,) * 5),
    "pdist_bf16": ("pdist_sql2_bf16", (_P, _P, _P) + (_I,) * 5),
    "pdist_f16": ("pdist_sql2_f16", (_P, _P, _P) + (_I,) * 5),
    "rankeval": ("rankeval", (_P,) * 7 + (_I,) * 5),
    "range_filter": ("range_filter", (_P,) * 5 + (_I,) * 5),
    "range_filter_bf16": ("range_filter_bf16", (_P,) * 5 + (_I,) * 5),
    "range_filter_f16": ("range_filter_f16", (_P,) * 5 + (_I,) * 5),
    "pdist_rankeval": ("pdist_rankeval", (_P,) * 10 + (_I,) * 7),
    "pdist_l1": ("pdist_l1", (_P, _P, _P) + (_I,) * 6),
    "pdist_linf": ("pdist_linf", (_P, _P, _P) + (_I,) * 6),
    "flash_attention": ("flash_attention_{}", (_P,) * 4 + (_I,) * 9),
}
# host functions of a library (no launch of their own, no count):
# name -> (source, argument types); each returns an int, a cudaError_t
# but for flash_attention_body (the body a flash launch takes)
HOST_FUNCS: dict[str, tuple[str, tuple]] = {
    "graph_loop_build": ("graph_loop.cu", (_P, _P, _I, _P, _I, _P, _P, _P)),
    "graph_loop_launch": ("graph_loop.cu", (_P, _P)),
    "graph_loop_destroy": ("graph_loop.cu", (_P, _P)),
    "flash_attention_body": ("flash_attention.cu", (_I, _I)),
}
# kernel name -> the variants of its C symbol (one per operand type)
VARIANTS = {"flash_attention": ("f32", "bf16")}
# kernel name -> its source under csrc/ (one source may hold several:
# pdist.cu and range_filter.cu an entry point for each point type, counted
# apart so a launch on a bf16 / f16 point plane shows as such)
SOURCES = {"pdist": "pdist.cu", "pdist_bf16": "pdist.cu",
           "pdist_f16": "pdist.cu", "rankeval": "rankeval.cu",
           "range_filter": "range_filter.cu",
           "range_filter_bf16": "range_filter.cu",
           "range_filter_f16": "range_filter.cu", "pdist_rankeval": "fused.cu",
           "pdist_l1": "pdist_lp.cu", "pdist_linf": "pdist_lp.cu",
           "flash_attention": "flash_attention.cu",
           "knn_loop_cond": "graph_loop.cu"}

# launches per kernel since the last reset_launches(): only launch() and
# add_launches() add, under _LAUNCH_LOCK (the router launches from one
# thread per replica, and ``+= 1`` on a dict entry is a
# read-modify-write)
LAUNCHES: dict[str, int] = {name: 0 for name in SOURCES}
_LAUNCH_LOCK = threading.Lock()
# the tally of the thread's open recording(), if any
_RECORDING = threading.local()

# filled once, by one update under _LOAD_LOCK: empty or complete; the
# kernels by (name, variant), the host functions by (name, None)
_FUNCS: dict[tuple[str, str | None], ctypes._CFuncPtr] = {}
_LOAD_LOCK = threading.Lock()


@dataclass
class Built:
    name: str
    path: Path
    seconds: float
    log: str


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@dataclass
class Tally:
    """What a :func:`recording` saw: launches by kernel name
    (``kernels``) and wrapper calls by wrapper name (``calls``, which
    ``ops`` fills for its observability counters)."""
    kernels: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)


@contextlib.contextmanager
def recording():
    """Within the block, this thread's launches are tallied in the
    yielded :class:`Tally` instead of :data:`LAUNCHES`: the launches of
    a CUDA graph's warm-up and capture, which are not the launches the
    graph's replays make."""
    prev = getattr(_RECORDING, "tally", None)
    _RECORDING.tally = tally = Tally()
    try:
        yield tally
    finally:
        _RECORDING.tally = prev


def current_recording() -> Tally | None:
    """This thread's open recording, or None."""
    return getattr(_RECORDING, "tally", None)


def add_launches(kernels: dict, times: int) -> None:
    """Count ``times`` launches of each kernel tallied in ``kernels``
    (name -> launches a replay makes): a graph's replays."""
    with _LAUNCH_LOCK:
        for name, n in kernels.items():
            LAUNCHES[name] += n * times


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or a CUDA_ROOTS entry."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(source: str, flags: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(extra_flags: tuple[str, ...] = (), build_dir: Path = BUILD_DIR,
          force: bool = False) -> dict[str, Built]:
    """Compile every source, one nvcc process each, all started
    together; returns the libraries by source name.  Raises
    ``RuntimeError`` with nvcc's output if any fails.  ``extra_flags``
    join the hash, so they build libraries of their own; ``force``
    rebuilds a library that exists."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + tuple(extra_flags)
    exe = nvcc()
    procs = {}
    for src in dict.fromkeys(SOURCES.values()):
        out = build_dir / f"{Path(src).stem}-{_digest(src, flags)}.so"
        if out.exists() and not force:
            procs[src] = (out, None, time.perf_counter())
            continue
        tmp = out.with_suffix(_tmp_suffix())
        cmd = [exe, *flags, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter())
    built = {}
    failed = []
    for src, (out, proc, t0) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(out.with_suffix(_tmp_suffix()), out)
        built[src] = Built(src, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def _tmp_suffix() -> str:
    """nvcc's output name before the rename: one per process and thread,
    so two builds never write the same file."""
    return f".{os.getpid()}.{threading.get_ident()}.tmp"


def _load() -> None:
    """Build and bind every library once.  The first thread in builds
    while any other waits on the lock; the table is published by one
    ``dict.update``, so a reader finds it empty or complete."""
    with _LOAD_LOCK:
        if _FUNCS:
            return
        libs = {src: ctypes.CDLL(str(b.path)) for src, b in build().items()}
        funcs = {}
        for name, (src, argtypes) in HOST_FUNCS.items():
            fn = getattr(libs[src], name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            funcs[name, None] = fn
        for name, (symbol, argtypes) in SIGNATURES.items():
            for variant in VARIANTS.get(name, (None,)):
                fn = getattr(libs[SOURCES[name]], symbol.format(variant))
                fn.argtypes = list(argtypes) + [_P]
                fn.restype = ctypes.c_int
                funcs[name, variant] = fn
        _FUNCS.update(funcs)


def current_stream(index: int) -> int:
    """The handle of device ``index``'s current stream, as an int: the
    raw ``cudaStream_t`` straight from PyTorch's C++ side where it offers
    that, without building a ``torch.cuda.Stream`` on every launch."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, *args, device: torch.device,
           variant: str | None = None) -> None:
    """Launch kernel ``name`` (its entry point ``variant``, for a kernel
    listed in :data:`VARIANTS`) on ``device``, the operands' device, on
    its current stream; the device is made current for the launch only
    where another one is.  ``args`` are the C arguments before the
    stream (device pointers as ints).  Raises ``RuntimeError`` if the
    launch reports a CUDA error."""
    if not _FUNCS:
        _load()
    fn = _FUNCS[name, variant]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, current_stream(index))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")
    tally = getattr(_RECORDING, "tally", None)
    if tally is not None:
        tally.kernels[name] = tally.kernels.get(name, 0) + 1
        return
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def host(name: str):
    """The bound host function ``name`` of :data:`HOST_FUNCS` (building
    and loading the libraries at the first call)."""
    if not _FUNCS:
        _load()
    return _FUNCS[name, None]
