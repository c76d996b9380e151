"""Hardware ceilings for the roofline model.

Port of ``repro/roofline/hw.py``.  The NVIDIA H100 SXM5 80 GB data sheet
(its full 700 W limit; a card set lower runs slower under load, so a
result names the card's limit beside it): :func:`machine_profile`
returns these ceilings on that card.  On any other card, or the CPU, no
one data-sheet number applies, so the peaks are *calibrated*: a float32
matrix product for peak FLOP/s and a streaming elementwise pass for
memory bandwidth, best of several runs (CUDA events on a card, the host
clock on the CPU), cached per process and device — an unmeasured
ceiling would make every utilization figure fiction.

:func:`bound` is the least time the card could take for a piece of
work: its bytes at the HBM rate against its operations at the peak rate
for their type, the larger of the two.
"""
from __future__ import annotations

import time

import torch

HBM_BW = 3.35e12                # bytes/s
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores, dense
NVLINK_BW = 450e9               # bytes/s each way, to each other card
HBM_BYTES = 80 * 10 ** 9        # 80 GB device memory
# flash_attention's bf16 body does Q K^T in one bf16 pass and P V in two
# (P split into bf16 hi + lo): 1.5 passes of the function's flops, its
# own cost (printed as a note); the bound counts the function's one pass
FLASH_TC_PASSES = 1.5

_calibrated: dict[str, dict] = {}


def bound(nbytes: float, flops: float,
          flop_per_s: float | None = None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time, ``nbytes`` at the
    HBM rate against ``flops`` at ``flop_per_s`` (default: f32)."""
    t_mem = nbytes / HBM_BW * 1e3
    t_ops = flops / (flop_per_s or PEAK_FLOPS_F32) * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def best_seconds(fn, reps: int, device: torch.device,
                 calls: int = 1) -> float:
    """Best seconds a call of ``fn`` over ``reps`` runs of ``calls``
    calls, after a warm-up call: CUDA events on a card, the host clock
    on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t = time.perf_counter() - t0
        best = min(best, t / calls)
    return best


def _calibrate(device: torch.device) -> dict:
    """Measured f32 matrix-product peak and streaming bandwidth."""
    key = str(device)
    if key in _calibrated:
        return _calibrated[key]
    gen = torch.Generator(device=device).manual_seed(0)
    m = 4096 if device.type == "cuda" else 1024
    a = torch.randn(m, m, generator=gen, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32
    try:
        t_mm = best_seconds(lambda: a @ a, 5, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    n = 1 << (27 if device.type == "cuda" else 24)    # past the caches
    v = torch.ones(n, device=device)
    t_st = best_seconds(lambda: v * 1.0001 + 1.0, 5, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    _calibrated[key] = {"name": f"{name} (calibrated)",
                        "peak_flops": 2.0 * m ** 3 / t_mm,
                        "mem_bw": 2.0 * n * 4 / t_st}    # read + write
    return _calibrated[key]


def is_h100_sxm(device) -> bool:
    """Whether ``device`` is the card the data-sheet ceilings are for."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    name = torch.cuda.get_device_name(dev)
    return "H100" in name and "HBM3" in name


def machine_profile(device=None) -> dict:
    """The roofline ceiling of ``device`` (default: the card; raises
    ``RuntimeError`` when there is none, as every entry point does):
    ``{"name", "peak_flops", "mem_bw", "calibrated"}``, ``peak_flops``
    the f32 rate the query kernels run at."""
    from ..kernels.dispatch import resolve_device
    dev = resolve_device(device)
    if is_h100_sxm(dev):
        return {"name": torch.cuda.get_device_name(dev) + " (data sheet)",
                "peak_flops": PEAK_FLOPS_F32, "mem_bw": HBM_BW,
                "calibrated": False}
    return dict(_calibrate(dev), calibrated=True)


__all__ = ["HBM_BW", "PEAK_FLOPS_F32", "PEAK_FLOPS_BF16", "NVLINK_BW",
           "HBM_BYTES", "FLASH_TC_PASSES", "bound", "best_seconds",
           "machine_profile", "is_h100_sxm"]
