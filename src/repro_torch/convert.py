"""Carry SSFN parameters, random matrices and datasets between ``repro``
(as numpy arrays) and the port.

``repro``'s arrays are JAX arrays; ``np.asarray`` on each gives what
these functions take and return, so neither package imports the other.
The two packages draw random numbers differently, so carrying ``repro``'s
R matrices and data across is how the same training problem reaches both.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ssfn import SSFNParams
from repro_torch.data.synthetic import Dataset


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


def r_from_numpy(
    r_list: Sequence[np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """The random matrices R_1..R_L as tensors on ``device`` (``None``
    means ``cuda``), for ``train_decentralized_ssfn(r=...)``."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(r), dtype=dtype, device=dev) for r in r_list)


def dataset_from_numpy(data, *, device: str | torch.device | None = None) -> Dataset:
    """A :class:`repro_torch.data.Dataset` on ``device`` (``None`` means
    ``cuda``) from anything with the six fields ``x_train``, ``t_train``,
    ``y_train``, ``x_test``, ``t_test`` and ``y_test`` (``repro``'s
    ``Dataset`` among them): features and targets as f32, labels as
    int64."""
    dev = resolve_device(device)

    def conv(name, dtype):
        return torch.tensor(np.asarray(getattr(data, name)), dtype=dtype, device=dev)

    return Dataset(
        x_train=conv("x_train", torch.float32),
        t_train=conv("t_train", torch.float32),
        y_train=conv("y_train", torch.int64),
        x_test=conv("x_test", torch.float32),
        t_test=conv("t_test", torch.float32),
        y_test=conv("y_test", torch.int64),
    )
