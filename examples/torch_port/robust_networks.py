"""dSSFN beyond the paper: quantized links, lossy links, stale
(asynchronous) peers, and non-IID data shards (the paper's §IV
future-work axis) — each non-ideal network is just a different
``ConsensusPolicy`` handed to the same solver.

    PYTHONPATH=src python examples/torch_port/robust_networks.py [--device cpu]

The PyTorch twin of ``examples/robust_networks.py``: the same threefry
key draws the same dataset, and the nine solves run in the same order
with the same policy seeds, so the stochastic links draw ``repro``'s
streams.  The oracle is the float64 constrained ridge.
"""
import argparse

import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.core import admm
from repro_torch.core.backend import SimulatedBackend
from repro_torch.core.policy import ExactMean, LossyGossip, QuantizedGossip, StaleMixing
from repro_torch.data import make_classification, partition_workers, partition_workers_noniid


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    key = prng.PRNGKey(0)
    data = make_classification(
        key=key, device=device, num_train=640, num_test=200, input_dim=24, num_classes=5
    )
    m = 8
    xw, tw = partition_workers(data.x_train, data.t_train, m)
    eps = 2.0 * data.num_classes
    oracle = admm.exact_constrained_ridge(
        data.x_train, data.t_train, eps_radius=eps
    )
    nrm = float(torch.linalg.norm(oracle))
    rel = lambda o: float(torch.linalg.norm(o - oracle)) / nrm

    backend = SimulatedBackend(m)

    def solve(policy, num_iters=200):
        return admm.admm_ridge_consensus(
            xw, tw, mu=1e-2, eps_radius=eps, num_iters=num_iters,
            backend=backend, policy=policy,
        )

    print("single-layer readout solve, M=8 workers, vs exact oracle:\n")
    errs = {}

    res = solve(ExactMean())
    errs["exact"] = rel(res.o_star)
    print(f"  ideal network (ExactMean):              rel err {errs['exact']:.1e}")

    for bits in (16, 8, 4):
        policy = QuantizedGossip(bits=bits)
        res = solve(policy)
        errs[f"quantized:{bits}"] = rel(res.o_star)
        print(f"  {bits:2d}-bit links ({policy.wire_bits/32:.2f}x traffic):        "
              f"rel err {errs[f'quantized:{bits}']:.1e}")

    for p in (0.05, 0.2):
        res = solve(LossyGossip(drop_prob=p, rounds=20, degree=2))
        errs[f"lossy:{p}"] = rel(res.o_star)
        print(f"  lossy gossip, {int(p*100):2d}% link drops:          "
              f"rel err {errs[f'lossy:{p}']:.1e}")

    for delay in (1, 3):
        res = solve(StaleMixing(delay), num_iters=400)
        errs[f"stale:{delay}"] = rel(res.o_star)
        print(f"  stale peers, {delay}-round-old values:        "
              f"rel err {errs[f'stale:{delay}']:.1e}")

    xw_n, tw_n = partition_workers_noniid(data.x_train, data.t_train, m)
    res_n = admm.admm_ridge_consensus(
        xw_n, tw_n, mu=1e-2, eps_radius=eps, num_iters=200, backend=backend
    )
    errs["noniid"] = rel(res_n.o_star)
    print(f"  pathologically non-IID shards:          rel err {errs['noniid']:.1e}"
          "   (distribution-free!)")
    return {"rel_err": errs}


if __name__ == "__main__":
    main()
