"""Carry SSFN parameters, random matrices, datasets and transformer
parameters between ``repro`` (as numpy arrays) and the port.

``repro``'s arrays are JAX arrays; ``np.asarray`` on each gives what
these functions take and return, so neither package imports the other.
The two packages draw random numbers differently, so carrying ``repro``'s
R matrices and data across is how the same training problem reaches both.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ssfn import SSFNParams
from repro_torch.data.synthetic import Dataset
from repro_torch.models.config import ModelConfig


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


def transformer_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter of a dense transformer, as a tree with
    the reference's names: per-layer weights stacked on a leading L axis."""
    L, d, f, v, hd = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.hd
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {
        "layers": {
            "ln1": (L, d),
            "ln2": (L, d),
            "attn": {"wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv), "wo": (L, q, d)},
            "ffn": {"wg": (L, d, f), "wu": (L, d, f), "wd": (L, f, d)},
        },
        "ln_f": (d,),
        "embed": (v, d),
        "head": (d, v),
    }


def transformer_params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, Any]:
    """The port's parameters (tensors on ``device``, ``None`` meaning
    ``cuda``; in ``dtype``, by default ``cfg.torch_dtype``) from
    ``jax.tree.map(np.asarray, params)`` of ``repro``'s
    ``TransformerModel.init``.  Names and layouts are the same; a tree
    whose keys or shapes do not match ``cfg`` raises ``ValueError``.
    bf16 arrays (numpy has no bf16 of its own) go through f32, which holds
    every bf16 value exactly."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype if dtype is None else dtype

    def conv(node, shape, path):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"params{path}: expected keys {sorted(shape)}, got {got}")
            return {k: conv(node[k], shape[k], f"{path}[{k!r}]") for k in shape}
        a = np.asarray(node)
        if a.shape != shape:
            raise ValueError(f"params{path}: expected shape {shape}, got {a.shape}")
        if a.dtype.kind != "f" or a.dtype.itemsize < 4:   # bf16 and f16
            a = a.astype(np.float32)
        return torch.tensor(a, dtype=dt, device=dev)   # a copy, never a view of `tree`

    return conv(tree, transformer_param_shapes(cfg), "")


def transformer_params_to_numpy(params: dict[str, Any]) -> dict[str, Any]:
    """The inverse of :func:`transformer_params_from_numpy`: the same tree
    of host numpy arrays; bf16 comes back as f32."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(params)
