"""dSSFN training launcher: the paper's Algorithm 1 on the card.

Port of ``repro/launch/train_dssfn.py`` for what the port runs so far:
layer-wise consensus-ADMM training of M workers on the simulated backend
(all workers on one device) with exact consensus.  Every Gram product of
the train goes through the hand-written CUDA kernels (``gram`` at layer
0, ``propagate_gram`` at every later layer)::

    python -m repro_torch.launch.train_dssfn --workers 20 --layers 20 \\
        --hidden 1020 --classes 10 --input-dim 784 --train 60000 \\
        --test 10000 --admm-iters 100 --export-artifact /tmp/stack
    python -m repro_torch.launch.serve_dssfn --artifact /tmp/stack

It runs on ``cuda`` unless ``--device cpu`` is given (the CPU takes the
kernels' plain versions).  The data is the planted-teacher problem of
``repro_torch.data`` drawn from ``--seed`` and the random matrices from
``--seed + 1``, on the run's device.  The result dict has ``repro``'s
keys, plus ``device`` and ``kernel_launches``, the CUDA kernel launches
per kernel during training and test evaluation.  ``--export-artifact``
writes the trained stack in ``repro``'s serving format, which
``repro_torch.launch.serve_dssfn`` (or ``repro``'s) serves.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=8, help="M, ADMM workers")
    ap.add_argument(
        "--backend", default="simulated", choices=["simulated", "mesh", "both"],
        help="where the workers run; only 'simulated' is ported",
    )
    ap.add_argument(
        "--consensus", default="exact",
        help="consensus spec; only 'exact' (one all-reduce) is ported",
    )
    ap.add_argument(
        "--partition", default="iid",
        help="worker data partition: iid | noniid[:alpha] (alpha in (0,1] "
        "= label-skew fraction per shard)",
    )
    ap.add_argument(
        "--trace-every", type=int, default=1,
        help="ADMM convergence-trace stride: 1 traces every iteration "
        "(default), 0 disables traces, N>1 traces every N-th iteration",
    )
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--admm-iters", type=int, default=100)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--input-dim", type=int, default=16)
    ap.add_argument("--train", type=int, default=960)
    ap.add_argument("--test", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--export-artifact", default=None, metavar="PATH",
        help="after training, export the trained stack as a serving "
        "artifact directory (repro_torch.serve.export_artifact)",
    )
    ap.add_argument("--out", default=None, help="optional JSON results path")
    ap.add_argument(
        "--device", default=None,
        help="torch device to train on (default: cuda, which must exist)",
    )
    return ap.parse_args(argv)


def _launch_counts() -> dict[str, int]:
    from repro_torch.kernels import gram, matmul_relu, propagate_gram

    return {
        "gram": gram.launch_count(),
        "propagate_gram": propagate_gram.launch_count(),
        "matmul_relu": matmul_relu.launch_count(),
    }


def train_one(kind: str, args, data, xw, tw, cfg, generator) -> dict:
    from repro_torch import dssfn
    from repro_torch._device import synchronize

    spec = dssfn.TrainSpec(
        cfg=cfg, backend=kind, workers=args.workers, policy=args.consensus,
        trace_every=args.trace_every,
    )
    before = _launch_counts()
    t0 = time.perf_counter()
    result = dssfn.train(spec, xw, tw, generator)
    params, log, backend = result.params, result.log, result.backend
    synchronize(params.o[-1].device)
    wall = time.perf_counter() - t0
    acc = dssfn.evaluate(result, data.x_test, data.y_test)
    after = _launch_counts()
    return {
        "backend": backend.describe(),
        "kind": kind,
        "policy": result.policy.describe(),
        "wire_bits": result.policy.wire_bits,
        "trace_every": args.trace_every,
        "wall_time_s": wall,
        "test_accuracy": acc,
        # trace_every=0 keeps no traces: no objective to report.
        "final_objective": log.layer_costs[-1] if log.layer_costs else None,
        "comm_scalars": log.comm_scalars,
        "jitter_events": int((log.jitter_levels > 0).sum()),
        "rollbacks": log.rollbacks,
        # One "lowering" per distinct layer program, not per layer solve.
        "executable_cache": backend.cache_info(),
        "device": str(params.o[-1].device),
        "kernel_launches": {k: after[k] - before[k] for k in after},
        "params": params,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import ssfn
    from repro_torch.data import make_classification, partition_by_spec

    dev = resolve_device(args.device)
    if args.backend != "simulated":
        raise NotImplementedError(
            f"--backend {args.backend}: only the simulated backend is ported "
            "(MeshBackend is ROADMAP Queue 1 item 5)"
        )
    print(f"device: {dev}", flush=True)

    data = make_classification(
        torch.Generator(device=dev).manual_seed(args.seed),
        num_train=args.train,
        num_test=args.test,
        input_dim=args.input_dim,
        num_classes=args.classes,
    )
    xw, tw = partition_by_spec(
        data.x_train, data.t_train, args.workers, args.partition
    )
    cfg = ssfn.SSFNConfig(
        input_dim=args.input_dim,
        num_classes=args.classes,
        num_layers=args.layers,
        hidden=args.hidden,
        admm_iters=args.admm_iters,
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)

    results: dict = {"config": vars(args), "device": str(dev), "runs": []}
    run = train_one(args.backend, args, data, xw, tw, cfg, generator)
    params = run.pop("params")
    results["runs"].append(run)
    obj = run["final_objective"]
    obj_str = f"{obj:.4f}" if obj is not None else "n/a (trace_every=0)"
    print(
        f"{run['backend']} on {dev}: wall={run['wall_time_s']:.2f}s "
        f"acc={run['test_accuracy']:.3f} obj={obj_str} "
        f"comm={run['comm_scalars']} scalars "
        f"kernel_launches={run['kernel_launches']}",
        flush=True,
    )

    if args.export_artifact:
        from repro_torch.serve import export_artifact

        export_artifact(
            args.export_artifact,
            params,
            source={
                "trained_by": "repro_torch.launch.train_dssfn",
                "backend": args.backend,
                "consensus": args.consensus,
                "workers": args.workers,
                "seed": args.seed,
                "device": str(dev),
            },
        )
        results["export"] = {
            "path": args.export_artifact,
            "source_kind": args.backend,
            "num_layers": len(params.o) - 1,
        }
        print(
            f"exported serving artifact -> {args.export_artifact} "
            f"({len(params.o) - 1} layers)",
            flush=True,
        )

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
