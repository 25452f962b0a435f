"""ctypes wrapper of the hand-written CUDA kernel ``csrc/ssm_scan.cu``.

Port of ``repro/kernels/ssm_scan/kernel.py`` (``ssm_scan_pallas``): the
Mamba2 chunked scan from a zero state.  It takes x, B and C of one dtype
(f32 or bf16), dt and a in f32, a chunk that is a multiple of 16 up to
256 dividing S, any head size dh (tiled by 32 rows in f32, by tiles of
32, 80 or 160 columns in bf16) and a state size ds up to 64.  The
wrapper checks what the kernel takes and raises on anything else,
allocates y, h_final and the kernels' scratch (each chunk's state sum,
(B, H, S / chunk, dh, ds) f32, and decay; for bf16 also the state at
each chunk's start as two bf16 pieces, (B, H, S / chunk, 2, dh, ds)),
launches on the current CUDA stream without synchronising, and counts
its launches: one per call, which runs the source's three kernels in
turn.
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
MAX_CHUNK = 256
CHUNK_MULTIPLE = 16
MAX_STATE = 64
_INT_MAX = 2**31 - 1
_MAX_GRID_YZ = 65535  # H and B * S / chunk are the grids' y and z dimensions
OUT_PIECES = 2  # kOutPieces of csrc/ssm_scan.cu: bf16 pieces of the state at a chunk's start

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
    lib = _build.load("ssm_scan")
    for fn in (lib.ssm_scan_f32, lib.ssm_scan_bf16):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, a, b_mat, c_mat, chunk) -> None:
    ts = (x, dt, a, b_mat, c_mat)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(
            "ssm_scan kernel needs x, dt, a, B and C on one CUDA device, got "
            + ", ".join(str(t.device) for t in ts)
        )
    if x.dtype not in DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(
            f"ssm_scan kernel takes x, B and C as float32 or bfloat16 of one dtype, "
            f"got {x.dtype}, {b_mat.dtype} and {c_mat.dtype}"
        )
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssm_scan kernel takes dt and a in float32, got {dt.dtype} and {a.dtype}")
    if x.ndim != 4:
        raise ValueError(f"ssm_scan needs x (B, S, H, dh), got {tuple(x.shape)}")
    b, s, h, dh = x.shape
    ds = b_mat.shape[-1] if b_mat.ndim == 3 else -1
    if (tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,)
            or tuple(b_mat.shape) != (b, s, ds) or tuple(c_mat.shape) != (b, s, ds)):
        raise ValueError(
            f"ssm_scan needs dt (B, S, H), a (H,), B and C (B, S, ds) for x "
            f"{tuple(x.shape)}, got {tuple(dt.shape)}, {tuple(a.shape)}, "
            f"{tuple(b_mat.shape)} and {tuple(c_mat.shape)}"
        )
    if not (isinstance(chunk, int) and CHUNK_MULTIPLE <= chunk <= MAX_CHUNK
            and chunk % CHUNK_MULTIPLE == 0):
        raise ValueError(
            f"ssm_scan kernel takes a chunk that is a multiple of {CHUNK_MULTIPLE} "
            f"up to {MAX_CHUNK}, got {chunk!r}"
        )
    if s < 1 or s % chunk:
        raise ValueError(f"ssm_scan needs S a positive multiple of chunk {chunk}, got S={s}")
    if not (1 <= ds <= MAX_STATE and 1 <= dh and 1 <= h <= _MAX_GRID_YZ
            and 1 <= b * (s // chunk) <= _MAX_GRID_YZ and x.numel() <= _INT_MAX
            and b * h * (s // chunk) * dh * ds <= _INT_MAX):
        raise ValueError(
            f"ssm_scan kernel takes 1 <= ds <= {MAX_STATE}, H and B * S / chunk up "
            f"to {_MAX_GRID_YZ} and fewer than 2**31 elements, got B={b} S={s} "
            f"H={h} dh={dh} ds={ds} chunk={chunk}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssm_scan kernel needs contiguous x, dt, a, B and C")


def ssm_scan_cuda(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b_mat: torch.Tensor,
    c_mat: torch.Tensor,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on the card: x (B, S, H, dh), dt (B, S, H), a (H,),
    B and C (B, S, ds) -> (y (B, S, H, dh) in x's dtype, h_final
    (B, H, dh, ds) f32)."""
    global _launches
    _check(x, dt, a, b_mat, c_mat, chunk)
    lib = _lib()
    fn = lib.ssm_scan_f32 if x.dtype == torch.float32 else lib.ssm_scan_bf16
    b, s, h, dh = x.shape
    ds = b_mat.shape[-1]
    y = torch.empty_like(x)
    h_final = torch.empty((b, h, dh, ds), dtype=torch.float32, device=x.device)
    states = torch.empty((b, h, s // chunk, dh, ds), dtype=torch.float32, device=x.device)
    decays = torch.empty((b, h, s // chunk), dtype=torch.float32, device=x.device)
    pieces = None
    if x.dtype == torch.bfloat16:
        pieces = torch.empty((b, h, s // chunk, OUT_PIECES, dh, ds), dtype=torch.bfloat16,
                             device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                 c_mat.data_ptr(), y.data_ptr(), h_final.data_ptr(), states.data_ptr(),
                 decays.data_ptr(), None if pieces is None else pieces.data_ptr(),
                 b, s, h, dh, ds, chunk, stream)
    if err != 0:
        raise RuntimeError(
            f"ssm_scan kernel launch failed with cudaError_t {err} "
            f"(B={b} S={s} H={h} dh={dh} ds={ds} chunk={chunk}, {x.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("ssm_scan", ACCUM_DTYPE, (y, h_final))
    return y, h_final
