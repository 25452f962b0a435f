"""ctypes wrapper of the hand-written CUDA kernel ``csrc/mlstm_scan.cu``.

Port of ``repro/kernels/mlstm_scan/kernel.py`` (``mlstm_scan_pallas``): the
chunked, stabilized mLSTM from the zero state.  It takes q, k and v of one
dtype (f32 or bf16), i_pre and f_pre in f32, a chunk that is a multiple of
16 up to 256 dividing S, and dk and dv up to 256 each.  The wrapper checks
what the kernel takes and raises on anything else, allocates y, the final
(C, n, m) and, in one buffer, the kernels' scratch (each chunk's state,
(B, H, S / chunk, dk dv + dk) f32, and three scalars per chunk; for bf16
also the carried C at each chunk's start as two bf16 pieces, (B, H,
S / chunk, 2, dk, dv)), launches on the current CUDA stream without
synchronising, and counts its launches: one per call, which runs the
source's three kernels in turn.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _record
from repro_torch.nn.xlstm import mlstm_scale

DTYPES = (torch.float32, torch.bfloat16)
#: The dtype every instance of the kernel accumulates in, whatever it
#: reads and writes (reported to a recording, :mod:`repro_torch.kernels._record`).
ACCUM_DTYPE = torch.float32
MAX_CHUNK = 256
CHUNK_MULTIPLE = 16
MAX_DIM = 256
_INT_MAX = 2**31 - 1
_MAX_GRID_Y = 65535  # B * H * S / chunk is a grid's y (f32) or z (bf16) dimension
OUT_PIECES = 2  # kOutPieces of csrc/mlstm_scan.cu: bf16 pieces of the carried C at a chunk's start

#: Launches of the kernel in this process; raised by one at each launch
#: and nowhere else.  Read with :func:`launch_count`.
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


#: The query scale 1/sqrt(dk) as the plain version forms it, once per dk.
_scale = functools.cache(mlstm_scale)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mlstm_scan")
    for fn in (lib.mlstm_scan_f32, lib.mlstm_scan_bf16):
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, i_pre, f_pre, chunk) -> None:
    ts = (q, k, v, i_pre, f_pre)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(
            "mlstm_scan kernel needs q, k, v, i_pre and f_pre on one CUDA device, got "
            + ", ".join(str(t.device) for t in ts)
        )
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"mlstm_scan kernel takes q, k and v as float32 or bfloat16 of one dtype, "
            f"got {q.dtype}, {k.dtype} and {v.dtype}"
        )
    if i_pre.dtype != torch.float32 or f_pre.dtype != torch.float32:
        raise TypeError(
            f"mlstm_scan kernel takes i_pre and f_pre in float32, got {i_pre.dtype} and "
            f"{f_pre.dtype}"
        )
    if q.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"mlstm_scan needs q, k (B, S, H, dk) and v (B, S, H, dv), got {tuple(q.shape)} "
            f"and {tuple(v.shape)}"
        )
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if (tuple(k.shape) != (b, s, h, dk) or tuple(v.shape[:3]) != (b, s, h)
            or tuple(i_pre.shape) != (b, s, h) or tuple(f_pre.shape) != (b, s, h)):
        raise ValueError(
            f"mlstm_scan needs k (B, S, H, dk), v (B, S, H, dv), i_pre and f_pre (B, S, H) "
            f"for q {tuple(q.shape)}, got {tuple(k.shape)}, {tuple(v.shape)}, "
            f"{tuple(i_pre.shape)} and {tuple(f_pre.shape)}"
        )
    if not (isinstance(chunk, int) and CHUNK_MULTIPLE <= chunk <= MAX_CHUNK
            and chunk % CHUNK_MULTIPLE == 0):
        raise ValueError(
            f"mlstm_scan kernel takes a chunk that is a multiple of {CHUNK_MULTIPLE} "
            f"up to {MAX_CHUNK}, got {chunk!r}"
        )
    if s < 1 or s % chunk:
        raise ValueError(f"mlstm_scan needs S a positive multiple of chunk {chunk}, got S={s}")
    slots = b * h * (s // chunk)
    if not (1 <= dk <= MAX_DIM and 1 <= dv <= MAX_DIM and 1 <= slots <= _MAX_GRID_Y
            and max(q.numel(), v.numel()) <= _INT_MAX):
        raise ValueError(
            f"mlstm_scan kernel takes dk and dv up to {MAX_DIM}, B * H * S / chunk up to "
            f"{_MAX_GRID_Y} and fewer than 2**31 elements, got B={b} S={s} H={h} dk={dk} "
            f"dv={dv} chunk={chunk}"
        )
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_scan kernel needs contiguous q, k, v, i_pre and f_pre")


def mlstm_scan_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    i_pre: torch.Tensor,
    f_pre: torch.Tensor,
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The chunked mLSTM on the card: q, k (B, S, H, dk), v (B, S, H, dv),
    i_pre and f_pre (B, S, H) -> (y (B, S, H, dv) in q's dtype, (C
    (B, H, dk, dv), n (B, H, dk), m (B, H)) f32)."""
    global _launches
    _check(q, k, v, i_pre, f_pre, chunk)
    lib = _lib()
    fn = lib.mlstm_scan_f32 if q.dtype == torch.float32 else lib.mlstm_scan_bf16
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    nc = s // chunk
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    c_out = torch.empty((b, h, dk, dv), **f32)
    n_out = torch.empty((b, h, dk), **f32)
    m_out = torch.empty((b, h), **f32)
    # One scratch allocation: the states, the scalars and, for bf16, the
    # pieces, each at a 256-byte aligned offset.
    states_bytes = _aligned(b * h * nc * (dk * dv + dk) * 4)
    scalars_bytes = _aligned(3 * b * h * nc * 4)
    pieces_bytes = b * h * nc * OUT_PIECES * dk * dv * 2 if q.dtype == torch.bfloat16 else 0
    scratch = torch.empty(states_bytes + scalars_bytes + pieces_bytes, dtype=torch.uint8,
                          device=dev)
    states = scratch.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(), f_pre.data_ptr(),
            y.data_ptr(), c_out.data_ptr(), n_out.data_ptr(), m_out.data_ptr(), states,
            states + states_bytes, states + states_bytes + scalars_bytes if pieces_bytes else None,
            b, s, h, dk, dv, chunk, _scale(dk))
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"mlstm_scan kernel launch failed with cudaError_t {err} "
            f"(B={b} S={s} H={h} dk={dk} dv={dv} chunk={chunk}, {q.dtype})"
        )
    _launches += 1
    if _record.hook is not None:
        _record.hook("mlstm_scan", ACCUM_DTYPE, (y, c_out, n_out, m_out))
    return y, (c_out, n_out, m_out)
