"""SSFN: Self Size-estimating Feed-forward Network (paper [1], §II-B).

Architecture:  y_{l+1} = g(W_{l+1} y_l),  g = ReLU,  y_0 = x,
with the structured weight

    W_{l+1} = [ V_Q @ O_l ; R_{l+1} ],      V_Q = [I_Q ; -I_Q]  (2Q x Q)

where O_l (Q x n_{l-1}) is the layer-l readout learned by the convex
problem (6) and R_{l+1} ((n-2Q) x n_{l-1}) is a frozen random matrix.
The V_Q block gives the lossless flow property: g(V_Q u) = [relu(u);
relu(-u)] retains u exactly, so cost is monotone in depth.

Every propagation ``relu(W y)`` here goes through the ``matmul_relu`` op:
the hand-written kernel for tensors on the card, its plain version on the
CPU.  Training propagates through ``propagate_gram`` instead
(``core/engine.py``).  So :class:`SSFNConfig` has no ``use_kernels``
field, unlike the reference's: on the port, CUDA tensors always launch
the kernels and CPU tensors take the plain versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.matmul_relu import matmul_relu


@dataclass(frozen=True)
class SSFNConfig:
    input_dim: int                  # P
    num_classes: int                # Q
    num_layers: int = 20            # L (paper §III-B)
    hidden: int | None = None       # n; paper default n = 2Q + 1000
    mu0: float = 1e-3               # ADMM Lagrangian parameter, layer 0
    mul: float = 1.0                # ADMM Lagrangian parameter, layers >= 1
    admm_iters: int = 100           # K (paper §III-B)
    eps_scale: float = 1.0          # eps_radius = eps_scale * 2Q
    dtype: torch.dtype = torch.float32

    @property
    def n(self) -> int:
        return self.hidden if self.hidden is not None else 2 * self.num_classes + 1000

    @property
    def eps_radius(self) -> float:
        return self.eps_scale * 2.0 * self.num_classes

    def __post_init__(self):
        if self.hidden is not None and self.hidden <= 2 * self.num_classes:
            raise ValueError("hidden n must exceed 2Q to leave room for R")


class SSFNParams(NamedTuple):
    """o[l] is the layer-l readout; r[l] the frozen random part of W_{l+1}."""
    o: tuple[torch.Tensor, ...]   # O_0 (Q,P), O_1..O_L (Q,n)
    r: tuple[torch.Tensor, ...]   # R_1 ((n-2Q),P), R_2..R_L ((n-2Q),n)


def v_q(q: int, dtype=torch.float32, device=None) -> torch.Tensor:
    eye = torch.eye(q, dtype=dtype, device=device)
    return torch.cat([eye, -eye], dim=0)


def init_random_matrices(
    cfg: SSFNConfig,
    *,
    generator: torch.Generator,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, ...]:
    """R_1..R_L, shared across all workers (Algorithm 1, input line 3):
    N(0, 1) / sqrt(fan_in) in ``cfg.dtype``, drawn in layer order from
    ``generator`` on its own device, then placed on ``device`` (``None``
    means ``cuda``, and raises without it).

    The draws are PyTorch's, not ``jax.random``'s: the same seed gives
    other matrices than ``repro``'s.  To hold the two packages against
    each other, carry ``repro``'s R across (``convert.r_from_numpy``)."""
    dev = resolve_device(device)
    n, p, q = cfg.n, cfg.input_dim, cfg.num_classes
    rs = []
    for l in range(cfg.num_layers):
        fan_in = p if l == 0 else n
        r = torch.randn(
            (n - 2 * q, fan_in), generator=generator, device=generator.device,
            dtype=cfg.dtype,
        )
        rs.append((r / math.sqrt(fan_in)).to(dev))
    return tuple(rs)


def build_weight(o_l: torch.Tensor, r_next: torch.Tensor, q: int) -> torch.Tensor:
    """W_{l+1} = [V_Q O_l ; R_{l+1}]   (paper eq. 7).

    V_Q O_l is [O_l ; -O_l] exactly, so it is written as that
    concatenation: no product that a TF32 setting could round."""
    if o_l.shape[0] != q:
        raise ValueError(f"readout has {o_l.shape[0]} rows, expected Q={q}")
    return torch.cat([o_l, -o_l, r_next], dim=0)


def forward_features(
    weights: Sequence[torch.Tensor], x: torch.Tensor, *, upto: int | None = None
) -> torch.Tensor:
    """y_l = g(W_l ... g(W_1 x)) for column-stacked inputs x: (P, J)."""
    y = x
    ws = weights if upto is None else weights[:upto]
    for w in ws:
        y = matmul_relu(w, y)
    return y


def assemble_weights(params: SSFNParams, q: int) -> tuple[torch.Tensor, ...]:
    """All W_1..W_L from (O_0..O_{L-1}, R_1..R_L)."""
    return tuple(
        build_weight(params.o[l], params.r[l], q) for l in range(len(params.r))
    )


def predict(params: SSFNParams, x: torch.Tensor, q: int) -> torch.Tensor:
    """t_hat = O_L y_L for inputs x: (P, J)."""
    weights = assemble_weights(params, q)
    y = forward_features(weights, x.contiguous())
    return params.o[-1] @ y


def classify(params: SSFNParams, x: torch.Tensor, q: int) -> torch.Tensor:
    return torch.argmax(predict(params, x, q), dim=0)


def layer_cost(o_l: torch.Tensor, y: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """C_l = sum_j ||t_j - O_l y_j||^2 (paper eq. 5)."""
    return torch.sum((t - o_l @ y) ** 2)
