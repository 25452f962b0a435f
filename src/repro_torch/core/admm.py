"""Consensus-ADMM solver for the paper's layer-wise convex problem.

Port of ``repro/core/admm.py`` on the backend path.  Decentralized
problem (paper eq. 9/10):

    min_{O_m, Z}  sum_m ||T_m - O_m Y_m||_F^2
    s.t.          ||Z||_F <= eps_radius,   O_m = Z  for all m

ADMM iterations (paper eq. 11):

    O_m^{k+1} = (T_m Y_m^T + (1/mu)(Z^k - Lam_m^k)) (Y_m Y_m^T + (1/mu) I)^{-1}
    Z^{k+1}   = P_eps( (1/M) sum_m (O_m^{k+1} + Lam_m^k) )       <- consensus
    Lam^{k+1} = Lam_m^k + O_m^{k+1} - Z^{k+1}

The workers are the leading dimension of every tensor, ``(M, ...)``.  The
Gram operand G_m = Y_m Y_m^T + I/mu is constant over k, so it is
factorized once per layer; its product goes through the ``gram`` op (the
hand-written CUDA kernel for tensors on the card, the plain version on
the CPU).  The O-update solves with the cached factor through PyTorch's
triangular solves, as the reference solves outside any kernel.
The only cross-worker communication per iteration is the policy's mix of
(O_m + Lam_m): Q x n floats, the paper's eq.-15 accounting.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple

import torch

from repro_torch.core.policy import ConsensusPolicy
from repro_torch.kernels.gram import gram

if TYPE_CHECKING:
    from repro_torch.core.backend import ConsensusBackend

Tensor = torch.Tensor


def project_frobenius(z: Tensor, radius: float) -> Tensor:
    """P_eps: scale each worker's (Q, n) block of z (..., Q, n) onto the
    Frobenius ball of the given radius (paper eq. after 11)."""
    norm = torch.linalg.vector_norm(z, dim=(-2, -1), keepdim=True)
    scale = torch.where(
        norm > radius, radius / norm.clamp_min(1e-30), torch.ones_like(norm)
    )
    return z * scale


class ADMMState(NamedTuple):
    o: Tensor      # (M, Q, n) per-worker primal variables
    z: Tensor      # (M, Q, n) per-worker consensus estimates
    lam: Tensor    # (M, Q, n) scaled duals


class ADMMTrace(NamedTuple):
    objective: Tensor        # (K,) global objective sum_m ||T_m - Z Y_m||^2
    primal_residual: Tensor  # (K,) ||O_m - Z|| aggregated
    dual_residual: Tensor    # (K,) ||Z^{k+1} - Z^k||
    consensus_error: Tensor  # (K,) max deviation of the consensus estimate


class ADMMResult(NamedTuple):
    o_star: Tensor   # (Q, n) final consensus solution Z^K (worker 0's)
    o_workers: Tensor
    lam: Tensor
    trace: "ADMMTrace | None"   # None when trace_every=0 (hot path)
    #: (M,) per-worker guarded-Cholesky jitter level (int32; 0 = factored
    #: clean).
    jitter: "Tensor | None" = None


def guarded_cholesky(
    g: Tensor, *, max_tries: int = 6, base_jitter: float = 1e-8
) -> tuple[Tensor, Tensor]:
    """Cholesky with escalating diagonal jitter, per matrix of g (..., n, n).

    Try G as-is, then G + eps_k I with ``eps_k = scale * base_jitter *
    10**k`` (``scale`` = max(mean |diagonal|, 1), so the jitter is
    relative to the matrix's magnitude), escalating only the matrices
    that failed, until each factor is healthy or ``max_tries`` retries
    are spent.  A factorization fails when ``torch.linalg.cholesky_ex``
    reports it (``info != 0``) or its factor is non-finite (the
    reference's only signal).  Each try costs one host sync.

    Returns ``(chol, level)``: level (int32, shape ``g.shape[:-2]``) 0
    means the plain factor was healthy; k >= 1 means it used
    ``eps_{k-1}``.  A factor still failing after ``max_tries`` is
    returned as NaN, as the reference returns it; the caller owns that
    failure.
    """
    n = g.shape[-1]
    batch = g.reshape(-1, n, n)
    eye = torch.eye(n, dtype=g.dtype, device=g.device)
    scale = batch.diagonal(dim1=-2, dim2=-1).abs().mean(dim=-1).clamp_min(1.0)

    def factor(mats):
        chol, info = torch.linalg.cholesky_ex(mats)
        return chol, (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))

    chol, failed = factor(batch)
    level = torch.zeros(batch.shape[0], dtype=torch.int32, device=g.device)
    for k in range(max_tries):
        idx = torch.nonzero(failed).flatten()
        if idx.numel() == 0:
            break
        eps = scale[idx] * base_jitter * 10.0**k
        chol[idx], failed[idx] = factor(batch[idx] + eps[:, None, None] * eye)
        level[idx] = k + 1
    chol[failed] = float("nan")
    return chol.reshape(g.shape), level.reshape(g.shape[:-2])


def _worker_stats(y_workers: Tensor, t_workers: Tensor, mu: float):
    """Per-worker A_m = T_m Y_m^T and guarded Cholesky of
    G_m = Y_m Y_m^T + I/mu (plus the per-worker jitter level), for
    stacked y (M, n, J_m) and t (M, Q, J_m).  The Gram goes through the
    ``gram`` op for all M workers at once and is cast to Y's dtype, as
    the reference's kernel path does."""
    y_workers = y_workers.contiguous()
    g = gram(y_workers, mu=mu).to(y_workers.dtype)
    chol, jitter = guarded_cholesky(g)
    a = torch.matmul(t_workers, y_workers.mT)
    return a, chol, jitter


def _worker_stats_local(y_m: Tensor, t_m: Tensor, mu: float):
    """One worker's view of :func:`_worker_stats`: y (n, J_m), t (Q, J_m)."""
    a, chol, jitter = _worker_stats(y_m[None], t_m[None], mu)
    return a[0], chol[0], jitter[0]


def _o_update(a: Tensor, chol: Tensor, z: Tensor, lam: Tensor, mu: float) -> Tensor:
    """O_m = (A_m + (Z - Lam_m)/mu) G_m^{-1} via the cached Cholesky factor
    L_m (G = L L^T): solve Y L^T = R, then O L = Y.

    These are the two triangular solves of the reference's ``cho_solve``
    (LAPACK's potrs), written out because ``torch.cholesky_solve`` on
    CUDA solves a batch with several right-hand sides one matrix at a
    time, while ``solve_triangular`` takes the M workers in one call."""
    rhs = a + (z - lam) / mu
    y = torch.linalg.solve_triangular(chol.mT, rhs, upper=True, left=False)
    return torch.linalg.solve_triangular(chol, y, upper=False, left=False)


def validate_trace_every(trace_every: int, num_iters: int) -> int:
    """Validate the trace-collection stride (shared by every entry point).

    ``1`` traces every ADMM iteration (the default), ``0`` disables
    trace collection entirely, ``N > 1`` traces every N-th iteration and
    requires ``num_iters % N == 0`` (traces are taken at iterations
    N, 2N, ..., K).
    """
    trace_every = int(trace_every)
    if trace_every < 0:
        raise ValueError(f"trace_every must be >= 0, got {trace_every}")
    if trace_every > 1 and num_iters % trace_every != 0:
        raise ValueError(
            f"trace_every={trace_every} must divide num_iters={num_iters}"
        )
    return trace_every


def _check_interval(policy: ConsensusPolicy, num_iters: int, trace_every: int) -> None:
    """The reference's guards for a communication interval N > 1, then a
    refusal: its chunks of local rounds come with ``AsyncGossip``."""
    interval = policy.communication_interval
    if interval <= 1:
        return
    if num_iters % interval != 0:
        raise ValueError(
            f"communication interval {interval} must divide "
            f"num_iters={num_iters}"
        )
    if trace_every > 1:
        raise ValueError(
            "trace_every > 1 does not compose with a communication "
            "interval; use trace_every of 0 or 1"
        )
    raise NotImplementedError(
        f"communication_interval={interval} (AsyncGossip's local rounds) is "
        "not ported yet: ROADMAP Queue 1 item 4"
    )


def worker_admm_iterations(
    backend: "ConsensusBackend",
    a: Tensor,
    chol: Tensor,
    y_m: Tensor,
    t_m: Tensor,
    z_init: Tensor,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
    policy: ConsensusPolicy | None = None,
    trace_every: int = 1,
):
    """K eq.-11 iterations over the cached factor, for all M workers.

    a (M, Q, n), chol (M, n, n), y_m (M, n, J_m), t_m (M, Q, J_m) are
    stacked; z_init is (Q, n) or (M, Q, n).  All cross-worker
    communication goes through ``policy.mix`` (default: the backend's
    policy) on the backend's collectives, and the policy's state is
    threaded through the iterations.  Each worker projects its OWN
    consensus estimate (they coincide under exact consensus).

    ``trace_every`` gates the convergence traces, which cost a sum over
    every worker's residual: 0 computes none, N >= 1 traces every N-th
    iteration.  The iterates do not depend on it.  Traces are worker
    0's view, as the reference reports them.

    Returns ``(o, z, lam), traces`` with ``traces`` the
    ``(objs, primals, duals, cerrs)`` tuple of (K/N,) tensors, or None
    when ``trace_every=0``.
    """
    policy = policy if policy is not None else backend.policy
    trace_every = validate_trace_every(trace_every, num_iters)
    _check_interval(policy, num_iters, trace_every)
    ctx = backend.ctx()
    zeros = torch.zeros_like(a)
    o, z, lam = zeros, z_init.to(a.dtype).expand_as(a), zeros
    pstate = policy.init_state(zeros, ctx)
    traced = []
    for k in range(num_iters):
        o = _o_update(a, chol, z, lam, mu)
        avg, pstate = policy.mix(o + lam, pstate, ctx)
        z_prev, z = z, project_frobenius(avg, eps_radius)
        lam = lam + o - z
        if trace_every and (k + 1) % trace_every == 0:
            if policy.is_exact:
                # avg IS the mean: the deviation is zero by construction.
                cerr = torch.zeros((), dtype=avg.dtype, device=avg.device)
            else:
                dev = (avg - backend.exact_mean(avg)).abs().amax(dim=(-2, -1))
                cerr = backend.pmax(dev)[0]
            obj = ((t_m - torch.matmul(z, y_m)) ** 2).sum(dim=(-2, -1)).sum()
            primal = torch.sqrt(((o - z) ** 2).sum(dim=(-2, -1)).sum())
            dual = torch.linalg.vector_norm(z[0] - z_prev[0])
            traced.append((obj, primal, dual, cerr))
    if not traced:
        return (o, z, lam), None
    return (o, z, lam), tuple(torch.stack(col) for col in zip(*traced))


def admm_ridge_consensus(
    y_workers: Tensor,
    t_workers: Tensor,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
    consensus_fn: Callable[[Tensor], Tensor] | None = None,
    backend: "ConsensusBackend | None" = None,
    policy: ConsensusPolicy | None = None,
    z0: Tensor | None = None,
    trace_every: int = 1,
) -> ADMMResult:
    """Run K iterations of consensus ADMM (paper Algorithm 1, lines 5-10).

    y_workers: (M, n, J_m) per-worker feature matrices (equal shard sizes,
        the paper's uniform division of the training set).
    t_workers: (M, Q, J_m) per-worker targets.
    backend: where the M workers run; defaults to ``SimulatedBackend(M)``.
    policy: how they reach consensus; defaults to the backend's policy.
    consensus_fn: the reference's legacy dense-H simulation; not ported
        (it raises ``NotImplementedError``).
    trace_every: convergence-trace stride (``worker_admm_iterations``).
    """
    if consensus_fn is not None:
        raise NotImplementedError(
            "the legacy dense-H consensus_fn simulation is not ported; pass "
            "backend=/policy= (the gossip family is ROADMAP Queue 1 item 4)"
        )
    from repro_torch.core.backend import SimulatedBackend

    if backend is None:
        backend = SimulatedBackend(y_workers.shape[0])
    m = y_workers.shape[0]
    if m != backend.num_workers:
        raise ValueError(
            f"y_workers has {m} worker shards, backend expects {backend.num_workers}"
        )
    policy = policy if policy is not None else backend.policy
    policy.validate(backend.num_workers)
    trace_every = validate_trace_every(trace_every, num_iters)
    q, n = t_workers.shape[1], y_workers.shape[1]
    dtype = y_workers.dtype
    z_init = (
        torch.zeros((q, n), dtype=dtype, device=y_workers.device)
        if z0 is None else z0.to(dtype)
    )

    def worker(y_m, t_m, z_init_rep):
        a, chol, jitter = _worker_stats(y_m, t_m, mu)
        state, traces = worker_admm_iterations(
            backend, a, chol, y_m, t_m, z_init_rep,
            mu=mu, eps_radius=eps_radius, num_iters=num_iters, policy=policy,
            trace_every=trace_every,
        )
        return state, traces, jitter

    key = ("admm_ridge", float(mu), float(eps_radius), int(num_iters), trace_every)
    (o_w, z_w, lam_w), traces, jitter_w = backend.run(
        worker, y_workers, t_workers, replicated=(z_init,), key=key,
        policy=policy,
    )
    return ADMMResult(
        o_star=z_w[0], o_workers=o_w, lam=lam_w,
        trace=None if traces is None else ADMMTrace(*traces), jitter=jitter_w,
    )


def centralized_ridge_admm(
    y: Tensor,
    t: Tensor,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
) -> ADMMResult:
    """Centralized SSFN layer solve = the same ADMM with M=1 (paper [1])."""
    return admm_ridge_consensus(
        y[None], t[None], mu=mu, eps_radius=eps_radius, num_iters=num_iters
    )


def exact_constrained_ridge(
    y: Tensor,
    t: Tensor,
    *,
    eps_radius: float,
    tol: float = 1e-10,
    max_bisect: int = 200,
) -> Tensor:
    """Reference solution of  min ||T - OY||_F^2  s.t. ||O||_F <= eps_radius,
    in float64 (the oracle of the equivalence tests).

    Solved through the secular equation: O(lmb) = T Y^T (Y Y^T + lmb I)^{-1}
    with lmb >= 0 chosen by bisection so that ||O(lmb)||_F = eps_radius (or
    lmb = 0 if the unconstrained least-squares solution is feasible).
    """
    y64, t64 = y.double(), t.double()
    n = y64.shape[0]
    gram64 = y64 @ y64.T
    a = t64 @ y64.T
    eye = torch.eye(n, dtype=torch.float64, device=y.device)

    def o_of(lmb):
        return torch.linalg.solve(gram64 + (lmb + 1e-12) * eye, a.T).T

    def norm_of(lmb):
        return float(torch.linalg.vector_norm(o_of(lmb)))

    o0 = o_of(0.0)
    if float(torch.linalg.vector_norm(o0)) <= eps_radius + tol:
        return o0
    lo, hi = 0.0, 1.0
    while norm_of(hi) > eps_radius:
        hi *= 4.0
        if hi > 1e18:
            break
    for _ in range(max_bisect):
        mid = 0.5 * (lo + hi)
        if norm_of(mid) > eps_radius:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(1.0, hi):
            break
    return o_of(hi)
