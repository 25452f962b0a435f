"""Gated MLP (SwiGLU) block, port of ``repro/nn/mlp.py``."""
from __future__ import annotations

import torch

from repro_torch.sharding.parallel import enter_model, row_parallel


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
    *, model_split: bool = False,
) -> torch.Tensor:
    """x: (..., d); w_gate/w_up: (d, f); w_down: (f, d).  With
    ``model_split`` the weights are this rank's f-slice on a grid
    (``sharding/parallel.py``): ``w_gate``/``w_up`` column-parallel,
    ``w_down`` row-parallel, and the partial outputs added over the model
    row in f32 (``row_parallel``), where ``repro`` constrains h to
    (batch, None, tensor)."""
    if model_split:
        x = enter_model(x)
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return row_parallel(h, w_down) if model_split else h @ w_down
