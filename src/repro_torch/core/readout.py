"""dSSFN's layer-wise convex readout as a framework feature, over any
backbone of the model zoo (transformer, MoE, SSM, xLSTM, hybrid).

Port of ``repro/core/readout.py``.  The paper's W = [V_Q O ; R] structure
needs stacked same-width dense layers, which an arbitrary backbone does
not have; what carries over is the per-layer convex readout solved by
decentralized consensus ADMM with centralized equivalence:

- ``admm_solve_sharded``: the eq.-11 iteration with one ADMM worker per
  process.  ``repro`` runs it under ``shard_map`` over mesh axes; here the
  processes are the ranks of a ``launch/mesh.WorkerGroup`` (or its
  ``Transport``), the Z-update's consensus is one ``all_reduce`` sum and
  an ``exact_div`` by the rank count (one all-reduce of Q*n floats an
  iteration, the paper's B*K*Q*n load with B=1), and ``group=None`` is a
  single process, whose mean is the identity.
- ``layerwise_backbone_fit``: a readout for every tapped layer of a frozen
  (random) backbone, i.e. dSSFN with the backbone in the role of the
  R matrices; each tap's solve reaches the ``gram`` op.

Every factorization goes through ``admm.guarded_cholesky`` (``repro``
factors with a raw ``jnp.linalg.cholesky``); on a positive-definite G the
guarded factor is the raw one.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch._device import exact_div
from repro_torch.core import admm as admm_lib

Tensor = torch.Tensor


class ShardedADMMResult(NamedTuple):
    z: Tensor            # (Q, n) consensus readout (identical on every rank)
    objective: Tensor    # (K,) global objective trace (summed over ranks)


def _transport(group):
    """The ``Transport`` of a ``WorkerGroup``, a ``Transport`` as given, or
    None for a single process."""
    return None if group is None else getattr(group, "transport", group)


def _psum(x: Tensor, transport) -> Tensor:
    return x if transport is None else transport.all_reduce(x)


def _pmean(x: Tensor, transport) -> Tensor:
    if transport is None:
        return x
    return exact_div(transport.all_reduce(x), transport.size)


def admm_solve_sharded(
    y_local: Tensor,
    t_local: Tensor,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
    group=None,
) -> ShardedADMMResult:
    """Consensus-ADMM ridge solve, one worker per rank of ``group``.

    y_local: (n, J_local) this worker's features; t_local: (Q, J_local).
    The returned Z is the same on every rank (the mean makes them agree),
    the SPMD form of the paper's "every node learns the same SSFN".  The
    objective trace sums each rank's K local terms in one all-reduce at
    the end (the same sums ``repro``'s per-iteration ``psum`` takes).
    """
    transport = _transport(group)
    a, chol, _ = admm_lib._worker_stats_local(y_local, t_local, mu)
    z = torch.zeros_like(a)
    lam = torch.zeros_like(a)
    local_objs = []
    for _ in range(num_iters):
        o = admm_lib._o_update(a, chol, z, lam, mu)
        z = admm_lib.project_frobenius(_pmean(o + lam, transport), eps_radius)   # consensus
        lam = lam + o - z
        local_objs.append(torch.sum((t_local - z @ y_local) ** 2))
    objective = _psum(torch.stack(local_objs), transport) if local_objs else z.new_zeros((0,))
    return ShardedADMMResult(z=z, objective=objective)


def gram_share_solve_sharded(
    y_local: Tensor,
    t_local: Tensor,
    *,
    eps_radius: float,
    group=None,
    ridge: float = 1e-6,
) -> Tensor:
    """BEYOND-PAPER alternative to the per-iteration consensus ADMM: sum
    the Gram statistics over the ranks once and solve the global least
    squares locally.

    One all-reduce of n^2 + Q*n floats instead of K of Q*n.  ``ridge`` is a
    small numerical jitter relative to the mean diagonal, not ADMM's mu (a
    penalty that does not bias the fixed point): a large ridge would change
    the solution.  The eps ball is enforced by projection, exact whenever
    the constraint is inactive at the least-squares solution (the common
    case with the paper's eps = 2Q); an active constraint would need the
    secular equation (``admm.exact_constrained_ridge``) on the shared
    statistics.  Gram sharing needs less communication than ADMM when
    n < ~K*Q, and it exposes second-order statistics (Y Y^T, T Y^T) where
    the paper's workers expose readout iterates.
    """
    n = y_local.shape[0]
    stats = _psum(torch.cat([y_local @ y_local.mT, t_local @ y_local.mT]), _transport(group))
    gram, rhs = stats[:n], stats[n:]
    scale = exact_div(torch.trace(gram), n)
    gram = gram + (ridge * scale) * torch.eye(n, dtype=gram.dtype, device=gram.device)
    chol, _ = admm_lib.guarded_cholesky(gram)
    return admm_lib.project_frobenius(admm_lib.solve_right(rhs, chol), eps_radius)


def fit_readout(
    y: Tensor,
    t: Tensor,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
) -> Tensor:
    """Single-worker convenience wrapper (centralized layer solve)."""
    res = admm_lib.centralized_ridge_admm(
        y, t, mu=mu, eps_radius=eps_radius, num_iters=num_iters
    )
    return res.o_star


class BackboneFit(NamedTuple):
    readouts: tuple[Tensor, ...]    # one (Q, n_l) readout per tapped layer
    layer_costs: Tensor             # (num_layers,) final objective per layer


def layerwise_backbone_fit(
    layer_features: Sequence[Tensor],
    targets: Tensor,
    *,
    mu: float = 1e-1,
    eps_scale: float = 1.0,
    num_iters: int = 50,
) -> BackboneFit:
    """Fit a convex readout to every layer of a frozen backbone.

    layer_features: sequence of (n_l, J) feature matrices (layer taps of any
        backbone, computed with frozen/random weights: the generalized "R").
    targets: (Q, J).

    Returns per-layer readouts; the SSFN monotone-cost property does not
    bind here (no V_Q feedthrough between arbitrary blocks), so
    layer_costs is reported for inspection rather than asserted monotone.
    """
    q = targets.shape[0]
    eps_radius = eps_scale * 2.0 * q
    readouts, costs = [], []
    for y in layer_features:
        o = fit_readout(y, targets, mu=mu, eps_radius=eps_radius, num_iters=num_iters)
        readouts.append(o)
        costs.append(torch.sum((targets - o @ y) ** 2))
    return BackboneFit(readouts=tuple(readouts), layer_costs=torch.stack(costs))


def make_sharded_layer_solver(
    group=None,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
):
    """A distributed layer solver over the ranks of ``group`` (a
    ``WorkerGroup``, its ``Transport``, or None for one process).

    The solver takes the whole y (n, J) and t (Q, J) on every rank, keeps
    this rank's contiguous block of J / ranks samples (``repro`` shards J
    over its data axes, ``P(None, data_axes)``), runs one ADMM worker per
    rank and returns the consensus readout every rank holds.  J must be a
    multiple of the rank count.
    """
    transport = _transport(group)
    size, rank = (1, 0) if transport is None else (transport.size, transport.rank)

    def solver(y: Tensor, t: Tensor) -> ShardedADMMResult:
        j = y.shape[-1]
        if j % size:
            raise ValueError(f"J={j} samples do not split over {size} ranks")
        block = slice(rank * (j // size), (rank + 1) * (j // size))
        return admm_solve_sharded(y[:, block], t[:, block], mu=mu, eps_radius=eps_radius,
                                  num_iters=num_iters, group=group)

    return solver
