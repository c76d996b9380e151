"""flash_attention: GQA online-softmax attention, causal or not.

Port of ``repro/kernels/flash_attention.py`` (``flash_attention_pallas``,
body ``_flash_kernel``).  On CUDA tensors :func:`flash_attention`
launches ``csrc/flash_attention.cu`` (entry points
``flash_attention_f32`` and ``flash_attention_bf16``); on CPU tensors it
runs the plain version ``ref.flash_attention_ref``, which repeats the
kernel's recurrence over 128-wide kv blocks.  Operands come padded:
Sq and Sk multiples of 128 (``ops.flash_attention`` pads and passes
``kv_len``).  ``window`` masks keys with ``qpos - kpos >= window`` (a
sliding window, mixtral's 4,096).  bf16 at head widths 64, 80, 112 and
128 runs on the tensor-core body; widths 80 and 112 (zamba2, kimi-k2)
there in the padded layout (tiles of 128 columns, the columns past D
zero-filled by TMA).  f32 at every width, and bf16 at 16 and 32, run on
the CUDA-core body; :func:`body` asks the library which body a launch
takes.
"""
from __future__ import annotations

import torch

from . import _cuda
from .ref import flash_attention_ref

TILE = 128                      # Sq and Sk come padded to multiples of this
HEAD_DIMS = (16, 32, 64, 80, 112, 128)   # the widths the kernel is built for
_VARIANT = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_operands(q, k, v) -> torch.device:
    """The common device of q, k and v; raises on mixed devices, on
    shapes outside the contract and, for CUDA operands, on a type other
    than f32 or bf16, mixed types, a head width the kernel is not built
    for or a non-contiguous operand."""
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, D) and k, v "
                         f"(B, Hk, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk, hk, sk, dk = k.shape
    if bk != b or dk != d or hq % hk != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} (Hq % Hk must be 0)")
    if sq % TILE or sk % TILE:
        raise ValueError(f"flash_attention: Sq {sq} and Sk {sk} must be "
                         f"multiples of {TILE} (ops.flash_attention pads)")
    if dev.type == "cuda":
        if q.dtype not in _VARIANT or k.dtype != q.dtype \
                or v.dtype != q.dtype:
            raise ValueError(f"the CUDA kernel takes f32 or bf16 operands "
                             f"of one type, got {q.dtype}, {k.dtype}, "
                             f"{v.dtype}")
        if d not in HEAD_DIMS:
            raise ValueError(f"the CUDA kernel is built for head widths "
                             f"{HEAD_DIMS}, got {d}")
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("the CUDA kernel takes contiguous operands")
    return dev


def body(dtype: torch.dtype, d: int) -> int:
    """The body a CUDA launch of this type and head width takes, as the
    library decides it (``flash_attention_body``): 1 the tensor cores,
    0 the CUDA cores, -1 none (the launch is refused).  Builds the
    libraries at the first call."""
    return _cuda.host("flash_attention_body")(int(dtype == torch.bfloat16), d)


def flash_attention_cuda(q, k, v, causal: bool, kv_len: int,
                         window: int | None = None) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hk, sk, _ = k.shape
    out = torch.empty_like(q)
    _cuda.launch("flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, hq, hk, sq, sk, d, kv_len, int(causal),
                 window or 0, device=q.device, variant=_VARIANT[q.dtype])
    return out


def flash_attention(q, k, v, causal: bool = True, kv_len: int | None = None,
                    window: int | None = None) -> torch.Tensor:
    """(B, Hq, Sq, D) attention output in q's dtype; keys at or beyond
    ``kv_len`` (default: none) are masked, and with ``window`` keys with
    ``qpos - kpos >= window``."""
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if check_operands(q, k, v).type == "cuda":
        sk = k.shape[2]
        kv = sk if kv_len is None else kv_len
        if not 0 < kv <= sk:
            raise ValueError(f"kv_len {kv} outside (0, {sk}]")
        return flash_attention_cuda(q, k, v, causal, kv, window)
    return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                               window=window)
