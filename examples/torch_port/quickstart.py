"""Quickstart: train a decentralized SSFN (the paper's algorithm) on a
synthetic Satimage-shaped task and verify centralized equivalence —
through the ``repro_torch.dssfn`` facade, so the backend/policy wiring is
one spec object.

    PYTHONPATH=src python examples/torch_port/quickstart.py [--device cpu]

The PyTorch twin of ``examples/quickstart.py``: the same threefry keys
draw the same dataset and random matrices {R_l}, so it prints the same
numbers.  On the card both trains launch the ``gram`` and
``propagate_gram`` kernels.
"""
import argparse

from repro_torch import dssfn, prng
from repro_torch._device import resolve_device
from repro_torch.core import equivalence, layerwise, ssfn, topology
from repro_torch.core.policy import RingGossip
from repro_torch.data import paper_dataset, partition_workers


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must be available)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. Data: synthetic stand-in with the paper's Satimage geometry,
    #    uniformly divided over M = 8 workers (disjoint shards, never shared).
    data = paper_dataset("satimage", key=prng.PRNGKey(0), scale=0.1, device=device)
    m, degree = 8, 2
    xw, tw = partition_workers(data.x_train, data.t_train, m)

    # 2. Communication network: degree-2 circular topology (paper §III).
    #    The spectral gap of its mixing matrix tells us how many gossip
    #    rounds reach consensus to tolerance; the RingGossip policy then
    #    runs exactly that mixing as peer exchanges.
    h = topology.circular_mixing_matrix(m, degree)
    rounds = topology.gossip_rounds_for_tolerance(h, tol=1e-8)
    gap = topology.spectral_gap(h)
    print(f"circular graph M={m} d={degree}: spectral gap "
          f"{gap:.3f}, gossip rounds B={rounds}")

    # 3. dSSFN: layer-wise consensus-ADMM learning (Algorithm 1).
    cfg = ssfn.SSFNConfig(
        input_dim=data.input_dim, num_classes=data.num_classes,
        num_layers=6, hidden=2 * data.num_classes + 200,
        mu0=1e-3, mul=1e-2, admm_iters=100,
    )
    key = prng.PRNGKey(7)   # seeds the SHARED random matrices {R_l}
    # The unified spec grammar: "gossip:B:d" is the same string the
    # launcher's --consensus flag and the benchmarks use, and equals the
    # RingGossip(rounds=B, degree=d) policy object.
    spec = dssfn.TrainSpec(
        cfg=cfg, backend="simulated", workers=m,
        policy=f"gossip:{rounds}:{degree}",
    )
    assert spec.resolve_policy() == RingGossip(rounds=rounds, degree=degree)
    result = dssfn.train(spec, xw, tw, key=key)
    params_d, log = result.params, result.log
    print(f"dSSFN trained in {log.wall_time_s:.1f}s; layer costs: "
          + " ".join(f"{c:.1f}" for c in log.layer_costs))
    print(f"communication: {log.comm_scalars:,} scalars exchanged (eq. 15)")

    # 4. Centralized equivalence check (the paper's headline claim).
    params_c, _ = layerwise.train_centralized_ssfn(
        data.x_train, data.t_train, cfg, key=key
    )
    rep = equivalence.compare(params_c, params_d, data.x_test, data.num_classes)
    acc_d = dssfn.evaluate(result, data.x_test, data.y_test)
    acc_c = layerwise.accuracy(params_c, data.x_test, data.y_test, data.num_classes)
    print(f"test acc: centralized {acc_c:.3f} vs decentralized {acc_d:.3f}; "
          f"decision agreement {rep.agreement:.3f}")
    assert abs(acc_c - acc_d) < 0.05
    return {"spectral_gap": gap, "rounds": rounds, "wall_time_s": log.wall_time_s,
            "layer_costs": [float(c) for c in log.layer_costs],
            "comm_scalars": log.comm_scalars, "acc_c": acc_c, "acc_d": acc_d,
            "agreement": rep.agreement, "num_test": int(data.y_test.shape[0])}


if __name__ == "__main__":
    main()
