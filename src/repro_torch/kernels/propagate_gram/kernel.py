"""ctypes wrapper of the hand-written CUDA kernels ``csrc/propagate_gram.cu``.

Port of ``repro/kernels/propagate_gram/kernel.py``
(``propagate_gram_pallas``), batched over the worker axis with W shared.
One op call issues two kernels on the current stream (the propagation,
then the Gram of its f32 output) and counts as one launch.  The wrapper
checks what the kernels take and raises on anything else, allocates the
outputs (and, for bf16, the f32 copy of Y' the Gram pass reads, and
where J is sliced the Gram pass's workspace), and does not synchronise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _record
from repro_torch.kernels.gram.kernel import _MAX_J, _ptr, _workspace

DTYPES = (torch.float32, torch.bfloat16)
#: The dtype every instance of the kernel accumulates in, whatever it
#: reads and writes (reported to a recording, :mod:`repro_torch.kernels._record`).
ACCUM_DTYPE = torch.float32
_INT_MAX = 2**31 - 1
_MAX_WORKERS = 65535      # the grids' z and y dimensions
_MAX_ROWS = 65535 * 64    # n row tiles of 64 on the grid's y dimension

#: Op calls that launched the kernels in this process; raised by one at
#: each call and nowhere else.  Read with :func:`launch_count`.
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("propagate_gram")
    lib.propagate_gram_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.propagate_gram_workspace_floats.restype = ctypes.c_longlong
    for fn in (lib.propagate_gram_f32, lib.propagate_gram_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(w: torch.Tensor, y: torch.Tensor) -> None:
    if w.device.type != "cuda" or y.device != w.device:
        raise ValueError(
            f"propagate_gram kernel needs both operands on one CUDA device, "
            f"got w on {w.device} and y on {y.device}"
        )
    if w.dtype not in DTYPES or y.dtype != w.dtype:
        raise TypeError(
            f"propagate_gram kernel takes float32 or bfloat16 operands of one "
            f"dtype, got w {w.dtype} and y {y.dtype}"
        )
    if w.ndim != 2 or y.ndim != 3 or w.shape[1] != y.shape[1]:
        raise ValueError(
            f"propagate_gram needs w (n, n_prev) and y (M, n_prev, J), got "
            f"{tuple(w.shape)} and {tuple(y.shape)}"
        )
    n, n_prev = w.shape
    m, j = y.shape[0], y.shape[2]
    if (min(m, n, n_prev, j) < 1 or m > _MAX_WORKERS or n > _MAX_ROWS
            or max(n * n_prev, n_prev) > _INT_MAX or j > _MAX_J):
        raise ValueError(
            f"propagate_gram kernel takes 1 <= M <= {_MAX_WORKERS}, "
            f"1 <= n <= {_MAX_ROWS}, J <= {_MAX_J} and sizes < 2**31, got M={m} n={n} "
            f"n_prev={n_prev} J={j}"
        )
    if not (w.is_contiguous() and y.is_contiguous()):
        raise ValueError("propagate_gram kernel needs row-major contiguous operands")


def propagate_gram_cuda(
    w: torch.Tensor, y: torch.Tensor, *, mu: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Y', G) on the card: w (n, n_prev), y (M, n_prev, J) -> Y' (M, n, J)
    in w's dtype and G (M, n, n) f32."""
    global _launches
    _check(w, y)
    lib = _lib()
    n, n_prev = w.shape
    m, j = y.shape[0], y.shape[2]
    y_out = torch.empty((m, n, j), dtype=w.dtype, device=w.device)
    g = torch.empty((m, n, n), dtype=torch.float32, device=w.device)
    if w.dtype == torch.float32:
        fn, y32 = lib.propagate_gram_f32, None
    else:
        fn = lib.propagate_gram_bf16
        y32 = torch.empty((m, n, j), dtype=torch.float32, device=w.device)
    ws = _workspace(lib.propagate_gram_workspace_floats(m, n, j), w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            w.data_ptr(), y.data_ptr(), y_out.data_ptr(), _ptr(y32), g.data_ptr(),
            _ptr(ws), m, n, n_prev, j, 1.0 / mu, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"propagate_gram kernel launch failed with cudaError_t {err} "
            f"(M={m} n={n} n_prev={n_prev} J={j}, {w.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("propagate_gram", ACCUM_DTYPE, (y_out, g), ((w, y), {"mu": mu}))
    # y32 and ws may be freed on return: the caching allocator hands their
    # memory out again only to work queued after the Gram pass on this stream.
    return y_out, g
