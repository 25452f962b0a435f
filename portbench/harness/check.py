"""What decides ``correct``: a sampled train of the window against the
cell's plain reference (:mod:`portbench.reference.dssfn_ref`) in float64.

The reference draws the sampled train's inputs again from the seed and
trains on them; it takes nothing the program made.  Three numbers are
compared, each against a limit of the cell's own
(``workloads/<cell>.json``):

- ``readout_gap``: the worst layer's ||O_l - O_l^ref||_F / ||O_l^ref||_F
  over the 21 consensus readouts the train returns.  It carries every
  layer's statistics, solve and mix.
- ``objective_gap``: the worst |c - c^ref| / c^ref over the traced
  objective sum_m ||T_m - Z_m Y_m||^2 of every layer and iteration, which
  carries each layer's propagated features.
- ``logit_gap``: ||F - F^ref||_F / ||F^ref||_F of the trained net's
  outputs on the test split, the program's readouts and the reference's
  each run through the reference's float64 forward.
"""
from __future__ import annotations

import math
import sys
from typing import NamedTuple

import numpy as np
import torch

NUMBERS = ("readout_gap", "objective_gap", "logit_gap")


class Outputs(NamedTuple):
    """What one train of the program returned, kept for the check."""
    readouts: tuple          # O_0..O_L on the card
    objective: np.ndarray    # (L+1, K/trace_every) float32


def finite(out: Outputs) -> bool:
    return all(bool(torch.isfinite(o).all()) for o in out.readouts) and bool(
        np.isfinite(out.objective).all()
    )


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.to(torch.float64), b.to(device=a.device, dtype=torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def gaps(out: Outputs, ref, r, x_test, *, logits) -> dict:
    """The three numbers of one train's outputs against the reference's
    ``ref`` (a ``dssfn_ref.Result``) on the same R and test inputs, each
    net's test outputs taken by the reference's float64 ``logits``."""
    if len(out.readouts) != len(ref.readouts) or out.objective.shape != tuple(ref.objective.shape):
        return {name: math.inf for name in NUMBERS}
    readout = max(_rel(o, o_ref) for o, o_ref in zip(out.readouts, ref.readouts))
    obj = torch.from_numpy(np.asarray(out.objective, np.float64))
    objective = float(((obj - ref.objective).abs() / ref.objective.abs()).max())
    logit = _rel(logits(out.readouts, r, x_test), logits(ref.readouts, r, x_test))
    values = {"readout_gap": readout, "objective_gap": objective, "logit_gap": logit}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in values.items()}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    missing = set(NUMBERS) - set(limits)
    if missing:
        raise ValueError(f"the cell's file sets no limit for {sorted(missing)}")
    held = {name: {"value": values[name], "limit": limits[name]} for name in NUMBERS}
    return all(v["value"] <= v["limit"] for v in held.values()), held


def print_held(held: dict, attempted: int, failed: int) -> None:
    """The numbers compared beside their limits, as the last lines on
    standard error."""
    print(f"check: trains {attempted}, non-finite {failed}", file=sys.stderr)
    for name, v in held.items():
        print(f"check: {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
