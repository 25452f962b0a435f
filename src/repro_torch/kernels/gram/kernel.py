"""ctypes wrapper of the hand-written CUDA kernel ``csrc/gram.cu``.

Port of ``repro/kernels/gram/kernel.py`` (``gram_pallas``), batched over
the worker axis: the TPU kernel is vmapped over M workers, this one takes
all of them in one launch.  The wrapper checks what the kernel takes and
raises on anything else, allocates the output (and the workspace of the
J slices' partial sums, where J is sliced), launches on the current CUDA
stream without synchronising, and counts its launches.
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
_MAX_WORKERS = 65535  # the grid's z dimension
_MAX_J = 65535 * 4096  # J slices of 4096 on the grid's y dimension

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
    lib = _build.load("gram")
    lib.gram_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.gram_workspace_floats.restype = ctypes.c_longlong
    for fn in (lib.gram_f32, lib.gram_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(y: torch.Tensor) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"gram kernel needs a CUDA tensor, got one on {y.device}")
    if y.dtype not in DTYPES:
        raise TypeError(f"gram kernel takes float32 or bfloat16, got {y.dtype}")
    if y.ndim != 3:
        raise ValueError(f"gram needs y (M, n, J), got shape {tuple(y.shape)}")
    m, n, j = y.shape
    if min(m, n, j) < 1 or m > _MAX_WORKERS or n > _INT_MAX or j > _MAX_J:
        raise ValueError(
            f"gram kernel takes 1 <= M <= {_MAX_WORKERS}, 1 <= n < 2**31 and "
            f"1 <= J <= {_MAX_J}, "
            f"got M={m} n={n} J={j}"
        )
    if not y.is_contiguous():
        raise ValueError("gram kernel needs a row-major contiguous y")


def _workspace(floats: int, device: torch.device) -> torch.Tensor | None:
    """The kernels' f32 scratch, or None where they need none.  It may be
    freed on return: the caching allocator hands its memory out again only
    to work queued after the launches on this stream."""
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def gram_cuda(y: torch.Tensor, *, mu: float) -> torch.Tensor:
    """G_m = Y_m Y_m^T + I/mu on the card: y (M, n, J) -> (M, n, n) f32."""
    global _launches
    _check(y)
    lib = _lib()
    fn = lib.gram_f32 if y.dtype == torch.float32 else lib.gram_bf16
    m, n, j = y.shape
    g = torch.empty((m, n, n), dtype=torch.float32, device=y.device)
    ws = _workspace(lib.gram_workspace_floats(m, n, j), y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y.data_ptr(), g.data_ptr(), _ptr(ws), m, n, j, 1.0 / mu, stream)
    if err != 0:
        raise RuntimeError(
            f"gram kernel launch failed with cudaError_t {err} "
            f"(M={m} n={n} J={j}, {y.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("gram", ACCUM_DTYPE, g)
    return g
