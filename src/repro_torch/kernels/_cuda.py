"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each source in ``csrc/`` (one per kernel) compiles on its own into a
shared library with a plain C interface::

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
returns the launch's ``cudaGetLastError()``; :func:`launch` raises on a
nonzero code and otherwise counts the launch in :data:`LAUNCHES`.
Nothing here is touched when a module is imported: the CPU tests import
every module on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CUDA_ROOTS = ("/usr/local/cuda",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel name -> (C symbol, argument types without the trailing stream)
SIGNATURES: dict[str, tuple[str, tuple]] = {
    "pdist": ("pdist_sql2", (_P, _P, _P, _I, _I, _I)),
    "rankeval": ("rankeval", (_P,) * 7 + (_I,) * 4),
    "range_filter": ("range_filter", (_P,) * 5 + (_I,) * 3),
    "pdist_rankeval": ("pdist_rankeval", (_P,) * 10 + (_I,) * 5),
}
# kernel name -> its source under csrc/
SOURCES = {"pdist": "pdist.cu", "rankeval": "rankeval.cu",
           "range_filter": "range_filter.cu", "pdist_rankeval": "fused.cu"}

# launches per kernel since the last reset_launches(): only launch() adds
LAUNCHES: dict[str, int] = {name: 0 for name in SIGNATURES}

_FUNCS: dict[str, ctypes._CFuncPtr] = {}


@dataclass
class Built:
    name: str
    path: Path
    seconds: float
    log: str


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    """Compile every kernel, one nvcc process each, all started
    together.  Raises ``RuntimeError`` with nvcc's output if any fails.
    ``extra_flags`` (for example ``("-Xptxas", "-v")``) join the hash,
    so they build libraries of their own; ``force`` rebuilds a library
    that exists."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + tuple(extra_flags)
    exe = nvcc()
    procs = {}
    for name, src in SOURCES.items():
        out = build_dir / f"{Path(src).stem}-{_digest(src, flags)}.so"
        if out.exists() and not force:
            procs[name] = (out, None, time.perf_counter())
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *flags, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter())
    built = {}
    failed = []
    for name, (out, proc, t0) in procs.items():
        log = ""
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{log}")
                continue
            os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
        built[name] = Built(name, out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


def _load() -> None:
    for name, b in build().items():
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(b.path)), symbol)
        fn.argtypes = list(argtypes) + [_P]
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on PyTorch's current stream.  ``args`` are
    the C arguments before the stream (device pointers as ints).  Raises
    ``RuntimeError`` if the launch reports a CUDA error."""
    if not _FUNCS:
        _load()
    stream = torch.cuda.current_stream().cuda_stream
    err = _FUNCS[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
