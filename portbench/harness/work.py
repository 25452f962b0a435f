"""The work of a dSSFN train, counted from shapes, and the card's peaks.

Each function gives the least work one piece of the train needs: its
FLOPs, and the bytes of its inputs read once and its outputs written once
(float32, 4 bytes).  They are keyed by the mathematics, not by the
kernels that implement it, so they read the same whatever a later version
of the program launches.  Shapes: M workers of J_m samples, Q classes,
features of width d (P at layer 0, n after), d_prev the width a layer
propagates from.

The least time of a piece is the larger of its FLOPs at the f32 peak and
its bytes at the memory bandwidth (:func:`least_seconds`).
"""
from __future__ import annotations

from typing import NamedTuple

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its
#: 700 W power limit).
H100_SXM = {
    "tf32_flops": 495e12,
    "f32_simt_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}
#: The f32-accurate rate: three TF32 products a product (the split the
#: port's Gram kernels use), a third of the TF32 peak.  f32 work on the
#: CUDA cores (67 TFLOP/s) is held to the same peak, so no share can pass
#: what f32 accuracy allows on the tensor cores.
F32_PEAK_FLOPS = H100_SXM["tf32_flops"] / 3
HBM_BYTES_PER_S = H100_SXM["hbm_bytes_per_s"]
F32 = 4


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":  # type: ignore[override]
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":  # type: ignore[override]
        return Work(self.flops * k, self.bytes * k)


NONE = Work(0.0, 0.0)


def least_seconds(work: Work) -> float:
    """The least time of ``work`` on the card: FLOPs at the f32 peak or
    bytes at the HBM bandwidth, whichever is longer."""
    return max(work.flops / F32_PEAK_FLOPS, work.bytes / HBM_BYTES_PER_S)


def layer_stats(m: int, jm: int, q: int, d: int, d_prev: int | None) -> Work:
    """One layer's statistics for all M workers.

    d_prev None (layer 0): G_m = Y_m Y_m^T + I/mu on the input features.
    Otherwise first Y_m = relu(W Y_m) with W (d, d_prev).  Then
    A_m = T_m Y_m^T and the Cholesky factor of G_m.

    FLOPs: the propagation 2 d d_prev J_m per worker; the symmetric Gram
    once per distinct entry, d(d+1)/2 entries of 2 J_m each, plus the d
    diagonal adds; A 2 Q d J_m; Cholesky d^3 / 3.
    Bytes: W, the features in and T read; the new features (when
    propagated), the factor's triangle d(d+1)/2 and A written.
    """
    flops = m * (d * (d + 1) * jm + d + 2 * q * d * jm + d ** 3 / 3)
    read = m * q * jm
    written = m * (d * (d + 1) // 2 + q * d)
    if d_prev is None:
        read += m * d * jm
    else:
        flops += m * 2 * d * d_prev * jm
        read += d * d_prev + m * d_prev * jm
        written += m * d * jm
    return Work(float(flops), float(F32 * (read + written)))


def mix(m: int, q: int, d: int, exact: bool) -> Work:
    """One consensus over the M workers' (Q, d) blocks: the exact mean (a
    sum over the workers and a scale) or a dense doubly-stochastic M x M
    matrix (the gossip power H^B, which is dense for the paper's
    network) applied to them.  Bytes: the blocks read and written."""
    flops = m * q * d + q * d if exact else 2 * m * m * q * d
    return Work(float(flops), float(F32 * 2 * m * q * d))


def admm_iteration(m: int, jm: int, q: int, d: int, *, exact: bool, traced: bool) -> Work:
    """One eq.-11 ADMM iteration for all M workers, the mix included.

    FLOPs: the right-hand side A + (Z - Lam)/mu (3 per entry), two
    triangular solves of Q right-hand sides against the d x d factor
    (Q d^2 each), the mix, the projection onto the Frobenius ball (3 per
    entry), the dual update (2 per entry).  A traced iteration adds the
    objective sum_m ||T_m - Z_m Y_m||^2 (2 Q d J_m + 3 Q J_m per worker),
    the primal residual (3 per entry), worker 0's dual residual and,
    under gossip, the consensus error against the exact mean (3 per
    entry).
    Bytes: each factor's triangle read twice, A, Z and Lam read and O, Z
    and Lam written; a traced iteration reads Y_m and T_m once.
    """
    qd = q * d
    flops = m * (3 * qd + 2 * q * d * d + 3 * qd + 2 * qd)
    tri = d * (d + 1) // 2
    elems = m * (2 * tri + 6 * qd)
    if traced:
        flops += m * (2 * q * d * jm + 3 * q * jm + 3 * qd) + 3 * qd
        if not exact:
            flops += 3 * m * qd
        elems += m * (d * jm + q * jm)
    return Work(float(flops), float(F32 * elems)) + mix(m, q, d, exact)


def layer_widths(cfg: dict) -> list[tuple[int, int | None]]:
    """(d, d_prev) of every layer solve O_0..O_L: d_prev None at layer 0."""
    p, n = cfg["input_dim"], cfg["hidden"]
    return [(p, None)] + [(n, p if l == 1 else n) for l in range(1, cfg["num_layers"] + 1)]


def train(cfg: dict, *, exact: bool, trace_every: int) -> Work:
    """One whole decentralized train: every layer's statistics and its K
    ADMM iterations, traces at the cell's stride included."""
    m, q, k = cfg["workers"], cfg["num_classes"], cfg["admm_iters"]
    jm = cfg["num_train"] // m
    traced = k // trace_every if trace_every else 0
    total = NONE
    for d, d_prev in layer_widths(cfg):
        total = total + layer_stats(m, jm, q, d, d_prev)
        total = total + admm_iteration(m, jm, q, d, exact=exact, traced=False) * (k - traced)
        total = total + admm_iteration(m, jm, q, d, exact=exact, traced=True) * traced
    return total
