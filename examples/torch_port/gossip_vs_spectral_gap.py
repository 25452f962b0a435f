"""Gossip rounds vs the spectral-gap prediction, across topologies
(paper §III).

Gossip converges to the mean geometrically at rate |lambda_2(H)| (Boyd
et al.): after B rounds the worst-case deviation from the true mean
shrinks like lambda_2^B.  This script sweeps ``Gossip(rounds=1..8)``
over every first-class mixing graph on M=8 workers — ring, torus,
hypercube, fully-connected, Birkhoff-compiled geometric — measures the
actual consensus error through the backend seam, and checks it against
each topology's ``spectral_gap`` prediction, including the B that
``rounds_for_tolerance`` says should reach a target tolerance.

    PYTHONPATH=src python examples/torch_port/gossip_vs_spectral_gap.py [--device cpu]

The PyTorch twin of ``examples/gossip_vs_spectral_gap.py``: the same
threefry draw of x, so the same numbers.
"""
import argparse

import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.core.backend import SimulatedBackend
from repro_torch.core.policy import Gossip
from repro_torch.core.topology import (
    FullyConnected,
    Hypercube,
    RandomGeometric,
    Ring,
    Torus,
)

M = 8
MAX_ROUNDS = 8

TOPOLOGIES = (
    Ring(1),
    Ring(2),
    Torus(2, 4),
    Hypercube(),
    FullyConnected(),
    RandomGeometric(radius=0.5, seed=1),
)


def consensus_error(topo, rounds: int, x) -> float:
    """Max deviation from the true mean after B gossip rounds over topo."""
    backend = SimulatedBackend(M, policy=Gossip(rounds=rounds, topology=topo))
    mixed = backend.run(backend.consensus_mean, x)
    return float(torch.max(torch.abs(mixed - torch.mean(x, dim=0, keepdim=True))))


def sweep(topo, x, err0: float) -> dict:
    gap = topo.spectral_gap(M)
    lam2 = 1.0 - gap
    print(f"\n{topo.describe()}: spectral gap {gap:.3f} "
          f"(lambda_2 = {lam2:.3f}, {topo.edges_per_node(M)} edges/node)")
    print(f"{'B':>3} {'measured err':>14} {'lambda_2^B * err0':>18}")
    errs = []
    for rounds in range(1, MAX_ROUNDS + 1):
        err = consensus_error(topo, rounds, x)
        errs.append(err)
        print(f"{rounds:3d} {err:14.3e} {lam2 ** rounds * err0:18.3e}")

    # The trend the spectral gap predicts: geometric decay (monotone
    # non-increasing, and within a constant factor of lambda_2^B) — up
    # to the fp32 noise floor, where fast mixers park immediately.
    floor = 1e-6 * err0
    for b in range(1, len(errs)):
        assert errs[b] <= errs[b - 1] * (1 + 1e-6) + floor, (topo, b, errs)
    for b, err in enumerate(errs, start=1):
        assert err <= 10.0 * lam2 ** b * err0 + floor, (topo, b, err)
    return {"topology": topo.describe(), "gap": gap, "lam2": lam2,
            "edges": topo.edges_per_node(M), "errs": errs,
            "predicted": [lam2 ** b * err0 for b in range(1, MAX_ROUNDS + 1)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    x = torch.from_numpy(prng.normal(prng.PRNGKey(0), (M, 16))).to(device)
    err0 = float(torch.max(torch.abs(x - torch.mean(x, dim=0, keepdim=True))))

    sweeps = [sweep(topo, x, err0) for topo in TOPOLOGIES]

    # And the B that rounds_for_tolerance prescribes for 1e-6 relative
    # consensus must actually deliver it (the README's "choosing a
    # topology" guidance), on the paper's ring.
    tol = 1e-6
    ring = Ring(2)
    b_star = ring.rounds_for_tolerance(M, tol)
    err_star = consensus_error(ring, b_star, x)
    print(f"\n{ring.describe()}: B* = {b_star} rounds for tol {tol:.0e}: "
          f"measured err {err_star:.3e} (err0 {err0:.3e})")
    assert err_star <= 10.0 * tol * err0, (b_star, err_star)
    print("gossip-error trend matches the spectral-gap prediction "
          "for every topology")
    return {"err0": err0, "sweeps": sweeps, "b_star": b_star, "err_star": err_star}


if __name__ == "__main__":
    main()
