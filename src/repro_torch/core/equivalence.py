"""Centralized-equivalence metrics (the paper's headline claim).

Port of ``repro/core/equivalence.py``.  dSSFN with exact consensus solves
the *same* convex problem per layer as centralized SSFN, so, given the
same shared random matrices {R_l}, the learned parameters and
predictions must coincide up to ADMM convergence tolerance.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ssfn as ssfn_lib


class EquivalenceReport(NamedTuple):
    max_readout_gap: float      # max_l ||O_l^cen - O_l^dec||_F / ||O_l^cen||_F
    prediction_gap: float       # ||T_hat_cen - T_hat_dec||_F / ||T_hat_cen||_F
    agreement: float            # fraction of identical argmax decisions


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(a).clamp_min(1e-12))


def compare(
    params_cen: ssfn_lib.SSFNParams,
    params_dec: ssfn_lib.SSFNParams,
    x: torch.Tensor,
    q: int,
) -> EquivalenceReport:
    gaps = [_rel_gap(oc, od) for oc, od in zip(params_cen.o, params_dec.o)]
    pred_c = ssfn_lib.predict(params_cen, x, q)
    pred_d = ssfn_lib.predict(params_dec, x, q)
    agree = float((pred_c.argmax(dim=0) == pred_d.argmax(dim=0)).float().mean())
    return EquivalenceReport(max(gaps), _rel_gap(pred_c, pred_d), agree)
