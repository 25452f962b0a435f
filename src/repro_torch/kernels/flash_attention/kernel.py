"""ctypes wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``.

Port of ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas``).  Unlike the TPU kernel, which needs S to be
a multiple of its blocks, this one takes any S >= 1.  It takes a head_dim
up to 128 whose rows are whole 16-byte chunks (a multiple of 4 in f32, of
8 in bf16; every config's 64, 80, 120 and 128 are), on 16-byte aligned
operands.  k and v may have fewer heads than q (GQA): query head h reads
KV head h // (H / H_kv) in place, with no repeated copy.  bf16 runs on the
tensor cores, f32 on the CUDA cores.  The wrapper checks what the kernel
takes and raises on anything else, allocates the output, launches on the
current CUDA stream without synchronising, and counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _record

DTYPES = (torch.float32, torch.bfloat16)
#: The dtype every instance of the kernel accumulates in, whatever it
#: reads and writes (reported to a recording, :mod:`repro_torch.kernels._record`).
ACCUM_DTYPE = torch.float32
MAX_HEAD_DIM = 128
_INT_MAX = 2**31 - 1
_MAX_SLICES = 65535  # B * H, the grid's y dimension

#: Launches of the kernel in this process; raised by one at each launch
#: and nowhere else.  Read with :func:`launch_count`.
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def check_gqa_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, H, S, hd) and k, v (B, H_kv, S, hd) of one shape, with H a
    multiple of H_kv; raises ValueError naming the rule otherwise."""
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:] or k.shape[1] < 1 or q.shape[1] % k.shape[1]):
        raise ValueError(
            f"flash_attention needs q (B, H, S, hd) and k, v of one shape (B, H_kv, S, hd) "
            f"with H % H_kv == 0, got {tuple(q.shape)}, {tuple(k.shape)} and "
            f"{tuple(v.shape)}"
        )


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention kernel needs q, k and v on one CUDA device, got "
            f"{q.device}, {k.device} and {v.device}"
        )
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 operands of one "
            f"dtype, got {q.dtype}, {k.dtype} and {v.dtype}"
        )
    check_gqa_shapes(q, k, v)
    b, h, s, hd = q.shape
    if not (1 <= b * h <= _MAX_SLICES and 1 <= s and 1 <= hd <= MAX_HEAD_DIM
            and q.numel() <= _INT_MAX):
        raise ValueError(
            f"flash_attention kernel takes 1 <= B*H <= {_MAX_SLICES}, S >= 1, "
            f"1 <= hd <= {MAX_HEAD_DIM} and < 2**31 elements, got "
            f"B={b} H={h} S={s} hd={hd}"
        )
    if window is not None and not (isinstance(window, int) and window >= 1):
        raise ValueError(f"window must be None or a positive int, got {window!r}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous (B, H, S, hd) operands")
    if (hd * q.element_size()) % 16 or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(
            f"flash_attention kernel loads rows in 16-byte chunks: it needs hd a "
            f"multiple of {16 // q.element_size()} for {q.dtype} (got {hd}) and "
            f"16-byte aligned q, k and v"
        )


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int | None = None
) -> torch.Tensor:
    """Causal (sliding-window) attention on the card: q (B, H, S, hd), k
    and v (B, H_kv, S, hd) with H % H_kv == 0 -> (B, H, S, hd) in q's
    dtype."""
    global _launches
    _check(q, k, v, window)
    lib = _lib()
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    b, h, s, hd = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b * h, s, hd, h // k.shape[1], window or 0, 1.0 / hd**0.5, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with cudaError_t {err} "
            f"(B={b} H={h} H_kv={k.shape[1]} S={s} hd={hd} window={window}, {q.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("flash_attention", ACCUM_DTYPE, out, ((q, k, v), {"window": window}))
    return out
