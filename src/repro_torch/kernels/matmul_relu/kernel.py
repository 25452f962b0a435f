"""ctypes wrapper of the hand-written CUDA kernel ``csrc/matmul_relu.cu``.

Port of ``repro/kernels/matmul_relu/kernel.py`` (``matmul_relu_pallas``).
The wrapper checks what the kernel takes and raises on anything else,
allocates the output, launches on the current CUDA stream without
synchronising, and counts its launches.
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
_INT_MAX = 2**31 - 1

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
    lib = _build.load("matmul_relu")
    for fn in (lib.matmul_relu_f32, lib.matmul_relu_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(w: torch.Tensor, x: torch.Tensor) -> None:
    if w.device.type != "cuda" or x.device != w.device:
        raise ValueError(
            f"matmul_relu kernel needs both operands on one CUDA device, got "
            f"w on {w.device} and x on {x.device}"
        )
    if w.dtype not in DTYPES or x.dtype != w.dtype:
        raise TypeError(
            f"matmul_relu kernel takes float32 or bfloat16 operands of one "
            f"dtype, got w {w.dtype} and x {x.dtype}"
        )
    if w.ndim != 2 or x.ndim != 2 or w.shape[1] != x.shape[0]:
        raise ValueError(
            f"matmul_relu needs w (m, k) and x (k, n), got "
            f"{tuple(w.shape)} and {tuple(x.shape)}"
        )
    m, k = w.shape
    n = x.shape[1]
    if min(m, k, n) < 1 or max(m * k, k * n, m * n) > _INT_MAX:
        raise ValueError(
            f"matmul_relu kernel takes 1 <= sizes and < 2**31 elements per "
            f"operand, got m={m} k={k} n={n}"
        )
    if not (w.is_contiguous() and x.is_contiguous()):
        raise ValueError("matmul_relu kernel needs row-major contiguous operands")


def matmul_relu_cuda(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """relu(W @ X) on the card: W (m, k), X (k, n) -> (m, n) in W's dtype."""
    global _launches
    _check(w, x)
    lib = _lib()
    fn = lib.matmul_relu_f32 if w.dtype == torch.float32 else lib.matmul_relu_bf16
    m, k = w.shape
    n = x.shape[1]
    out = torch.empty((m, n), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(w.data_ptr(), x.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(
            f"matmul_relu kernel launch failed with cudaError_t {err} "
            f"(m={m} n={n} k={k}, {w.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("matmul_relu", ACCUM_DTYPE, out)
    return out
