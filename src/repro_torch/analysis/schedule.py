"""Static exchange-schedule checks.

Port of ``repro/analysis/schedule.py``, verbatim over
:mod:`repro_torch.core.topology`.  A compiled gossip schedule is a list
of ``(permutation, weight)`` hops plus a self weight.  Everything the
convergence story rests on is checkable without running a step:

- **doubly-stochastic** — the realized H has unit row AND column sums
  (the paper's consensus-preservation requirement);
- **Birkhoff weight-sum** — hop weights are positive and sum with the
  self weight to 1 (a broken Birkhoff decomposition shows up here);
- **inverse-closure** — every hop's reverse hop is present with equal
  weight; required for mean preservation under fault rerouting
  (``AsyncGossip.validate`` enforces it under non-null faults);
- **symmetry** — H == H^T, expected of undirected-topology schedules.

Each violation is a structured :class:`~repro_torch.analysis.findings.LintFinding`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import topology as topology_lib

from .findings import LintFinding

_TOL = 1e-6


def schedule_matrix(schedule) -> np.ndarray:
    """The realized mixing matrix H — built here WITHOUT the library's
    own validation (``ExchangeSchedule.as_matrix`` raises on the exact
    defects this checker exists to report)."""
    m = schedule.num_workers
    h = float(schedule.self_weight) * np.eye(m)
    for perm, w in zip(schedule.perms, schedule.weights):
        p = np.zeros((m, m))
        for s, d in perm:
            p[d, s] = 1.0
        h = h + float(w) * p
    return h


def check_schedule(
    schedule,
    *,
    subject: str,
    expect_inverse_closed: bool = False,
    expect_symmetric: bool = False,
    tol: float = _TOL,
) -> list[LintFinding]:
    findings: list[LintFinding] = []
    m = schedule.num_workers
    weights = [float(w) for w in schedule.weights]
    self_w = float(schedule.self_weight)

    bad_w = [w for w in weights if not w > 0.0]
    if bad_w or self_w < -tol:
        findings.append(LintFinding(
            check="schedule-weights",
            subject=subject,
            message="schedule carries non-positive hop weights",
            details={"weights": weights, "self_weight": self_w},
        ))
    total = self_w + sum(weights)
    if abs(total - 1.0) > tol:
        findings.append(LintFinding(
            check="schedule-weight-sum",
            subject=subject,
            message=(
                "Birkhoff weight sum is not 1 (hops + self weight must "
                "form a convex combination)"
            ),
            details={"weight_sum": total, "self_weight": self_w,
                     "num_hops": len(weights)},
        ))

    h = schedule_matrix(schedule)
    rows = h.sum(axis=1)
    cols = h.sum(axis=0)
    if np.abs(rows - 1.0).max() > tol or np.abs(cols - 1.0).max() > tol:
        findings.append(LintFinding(
            check="schedule-doubly-stochastic",
            subject=subject,
            message="realized mixing matrix is not doubly stochastic",
            details={
                "max_row_err": float(np.abs(rows - 1.0).max()),
                "max_col_err": float(np.abs(cols - 1.0).max()),
                "num_workers": m,
            },
        ))
    if (h < -tol).any():
        findings.append(LintFinding(
            check="schedule-nonnegative",
            subject=subject,
            message="realized mixing matrix has negative entries",
            details={"min_entry": float(h.min())},
        ))

    if expect_symmetric and np.abs(h - h.T).max() > tol:
        findings.append(LintFinding(
            check="schedule-symmetry",
            subject=subject,
            message="realized mixing matrix is not symmetric",
            details={"max_asymmetry": float(np.abs(h - h.T).max())},
        ))

    if expect_inverse_closed and not topology_lib.is_inverse_closed(
        schedule, tol=tol
    ):
        findings.append(LintFinding(
            check="schedule-inverse-closure",
            subject=subject,
            message=(
                "exchange schedule is not inverse-closed: fault "
                "rerouting on it would not preserve the up-set mean"
            ),
            details={"num_hops": len(schedule.perms)},
        ))
    return findings


def check_policy_schedules(policy, num_workers: int, *, subject: str):
    """Every schedule a policy can compile — each topology-cycle phase,
    plus the compressed H**B schedule when the policy would use one."""
    topo = getattr(policy, "topology", None)
    if topo is None:
        return []
    faults = getattr(policy, "faults", None)
    under_faults = faults is not None and not faults.is_null
    findings: list[LintFinding] = []
    phases = topo.cycle()
    for i, phase in enumerate(phases):
        sched = topology_lib.cached_exchange_schedule(phase, num_workers)
        tag = subject if len(phases) == 1 else f"{subject} [phase {i}]"
        findings.extend(check_schedule(
            sched, subject=tag,
            expect_inverse_closed=under_faults,
        ))
    compressed = getattr(policy, "_compressed_schedule_or_none", None)
    if compressed is not None:
        sched = compressed(num_workers)
        if sched is not None:
            findings.extend(check_schedule(
                sched, subject=f"{subject} [compressed H**B]",
            ))
    return findings
