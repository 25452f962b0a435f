"""Gated MLP (SwiGLU) block, port of ``repro/nn/mlp.py``."""
from __future__ import annotations

import torch


def swiglu(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
) -> torch.Tensor:
    """x: (..., d); w_gate/w_up: (d, f); w_down: (f, d)."""
    h = torch.nn.functional.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
