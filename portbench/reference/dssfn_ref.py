"""Plain reference of decentralized SSFN training (arXiv:2009.13982).

Written from the paper alone, in plain PyTorch, for the benchmark's
check: it imports nothing of the program.  Layer l's features are
Y_0 = X and Y_l = relu(W_l Y_{l-1}) with W_l = [O_{l-1}; -O_{l-1}; R_l]
(eq. 7).  Each layer solves

    min sum_m ||T_m - O Y_m||_F^2   s.t.  ||O||_F <= eps

by K iterations of consensus ADMM (eq. 11), every worker from
Z = Lam = 0:

    O_m  = (T_m Y_m^T + (Z_m - Lam_m)/mu) (Y_m Y_m^T + I/mu)^{-1}
    Z_m  = P_eps( sum_j H[m, j] (O_j + Lam_j) )
    Lam_m = Lam_m + O_m - Z_m

with H the consensus that the cell's traffic names, one rule a file
under :mod:`portbench.reference.mixing` (the exact mean, or B rounds of
gossip over a ring).  The layer's readout O_l is worker 0's Z after K
iterations.  Each traced iteration records sum_m ||T_m - Z_m Y_m||_F^2.

The inverse is applied through the Cholesky factor of the Gram, by two
triangular solves.  ``dtype`` and ``tf32`` set the precision: float64 is
the reference; float32 with TF32 products is the check's control.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch

from portbench.reference import mixing

Tensor = torch.Tensor


class Result(NamedTuple):
    readouts: list      # O_0..O_L, each (Q, d), in ``dtype``
    objective: Tensor   # (L+1, K) the traced objective, float64 on the CPU


def round_tf32(x: Tensor) -> Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest (ties away), as
    float32: the operands a TF32 product sees."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _precision(device: torch.device, tf32: bool):
    """TF32 products on the card when asked, and never otherwise."""
    if device.type != "cuda":
        yield
        return
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _matmul(tf32_emulated: bool):
    if tf32_emulated:
        return lambda a, b: torch.matmul(round_tf32(a), round_tf32(b))
    return torch.matmul


def project(z: Tensor, radius: float) -> Tensor:
    """Each worker's (Q, d) block onto the Frobenius ball of ``radius``."""
    norm = torch.sqrt((z * z).sum(dim=(-2, -1), keepdim=True))
    return torch.where(norm > radius, z * (radius / norm), z)


def train(
    x_workers: Tensor,
    t_workers: Tensor,
    r: Sequence[Tensor],
    *,
    mixing_spec: dict,
    mu0: float,
    mul: float,
    eps_radius: float,
    num_iters: int,
    trace_every: int = 1,
    dtype: torch.dtype = torch.float64,
    tf32: bool = False,
) -> Result:
    """Train on x (M, P, J_m), t (M, Q, J_m) with R_1..R_L, on their
    device, under the consensus ``mixing_spec`` (a traffic file's
    ``"mixing"``).  ``tf32`` computes every product with TF32 operands:
    the card's TF32 mode there, the operands rounded to TF32 on the
    CPU."""
    device = x_workers.device
    m = x_workers.shape[0]
    mm = _matmul(tf32 and device.type != "cuda")
    mix = mixing.make(mixing_spec, m, device=device, dtype=dtype)
    t = t_workers.to(dtype)
    y = x_workers.to(dtype)
    readouts, objective = [], []
    with _precision(device, tf32):
        for layer in range(len(r) + 1):
            if layer:
                o = readouts[-1]
                w = torch.cat([o, -o, r[layer - 1].to(dtype)], dim=0)
                y = torch.relu(mm(w, y))
            mu = mu0 if layer == 0 else mul
            d = y.shape[1]
            gram = mm(y, y.mT) + torch.eye(d, dtype=dtype, device=device) / mu
            chol = torch.linalg.cholesky(gram)
            a = mm(t, y.mT)
            z = torch.zeros_like(a)
            lam = torch.zeros_like(a)
            traced = []
            for k in range(num_iters):
                rhs = a + (z - lam) / mu
                # O = rhs G^{-1}: solve X L^T = rhs, then O L = X.
                half = torch.linalg.solve_triangular(chol.mT, rhs, upper=True, left=False)
                o_m = torch.linalg.solve_triangular(chol, half, upper=False, left=False)
                z = project(mix(o_m + lam, layer, k), eps_radius)
                lam = lam + o_m - z
                if trace_every and (k + 1) % trace_every == 0:
                    traced.append(((t - mm(z, y)) ** 2).sum())
            readouts.append(z[0].clone())
            objective.append(torch.stack(traced) if traced else torch.zeros(0, dtype=dtype, device=device))
    return Result(readouts, torch.stack(objective).to("cpu", torch.float64))


def logits(readouts: Sequence[Tensor], r: Sequence[Tensor], x: Tensor) -> Tensor:
    """The trained net's outputs O_L y_L for inputs x (P, J), in float64:
    y_0 = x, y_l = relu([O_{l-1}; -O_{l-1}; R_l] y_{l-1})."""
    f64 = torch.float64
    y = x.to(f64)
    for layer in range(1, len(readouts)):
        o = readouts[layer - 1].to(f64)
        y = torch.relu(torch.cat([o, -o, r[layer - 1].to(f64)], dim=0) @ y)
    return readouts[-1].to(f64) @ y
