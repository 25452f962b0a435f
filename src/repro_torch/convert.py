"""Carry SSFN parameters between ``repro`` (as numpy arrays) and the port.

``repro``'s parameters are JAX arrays; ``np.asarray`` on each gives the
lists these functions take and return, so neither package imports the
other.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ssfn import SSFNParams


def params_from_numpy(
    o_list: Sequence[np.ndarray],
    r_list: Sequence[np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> SSFNParams:
    """``SSFNParams`` of tensors on ``device`` (``None`` means ``cuda``,
    and raises without it) from the readouts O_0..O_L and the random
    matrices R_1..R_L."""
    dev = resolve_device(device)

    def conv(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return SSFNParams(
        o=tuple(conv(o) for o in o_list), r=tuple(conv(r) for r in r_list)
    )


def params_to_numpy(
    params: SSFNParams,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(O list, R list) as host numpy arrays; bf16 comes back as f32,
    which holds every bf16 value exactly."""

    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return [conv(o) for o in params.o], [conv(r) for r in params.r]
