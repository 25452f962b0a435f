"""dSSFN training launcher: the paper's Algorithm 1 on the card.

Port of ``repro/launch/train_dssfn.py``: layer-wise consensus-ADMM
training of M workers with exact consensus, the paper's gossip, its
quantized, lossy and stale links, asynchronous gossip under a seeded
fault model, or the Byzantine-robust policies, where ``--backend``
says:

- ``simulated``  all M workers on one device, one process (the default);
- ``mesh``       W ranks of a ``torch.distributed`` group (``--ranks W``,
                 default one worker a rank), each holding its block of
                 M/W workers and its data shards; only messages and
                 reductions cross between ranks;
- ``both``       the simulated run first, then the ranks, and their
                 parity (``parity.max_readout_rel_gap``,
                 ``parity.rel_objective_gap``).

The ranks are spawned on this host (``launch.mesh.spawn_workers``), or,
under ``torchrun``, are the launch's own processes; ``--dist-backend``
is ``nccl`` on the card and ``gloo`` on the CPU by default (NCCL takes
one card a rank, so several ranks on one card need ``--dist-backend
gloo``).  Every Gram product of the train goes through the hand-written
CUDA kernels (``gram`` at layer 0, ``propagate_gram`` at every later
layer; each rank launches them on its own block)::

    python -m repro_torch.launch.train_dssfn --workers 20 --layers 20 \\
        --hidden 1020 --classes 10 --input-dim 784 --train 60000 \\
        --test 10000 --admm-iters 100 --export-artifact /tmp/stack
    python -m repro_torch.launch.serve_dssfn --artifact /tmp/stack
    python -m repro_torch.launch.train_dssfn --device cpu --backend both \\
        --workers 8 --ranks 4 --layers 2 --hidden 40 --admm-iters 20
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_dssfn \\
        --device cpu --backend mesh --workers 8 --layers 2

Consensus is a policy spec in ``dssfn.parse_spec``'s grammar::

    --consensus exact           one all-reduce (the default)
    --consensus gossip:52:4     52 rounds of degree-4 ring gossip (the
                                paper's M=20 network at tolerance 1e-8)
    --consensus gossip:4@torus:2x4
    --consensus quantized:8     one 8-bit stochastically rounded all-reduce
    --consensus lossy:0.1:52:4  the gossip network with 10% link loss
    --consensus stale:2         peers see 2-rounds-stale values
    --consensus async:rounds=52:interval=4:drop=0.1:seed=7@ring:4
                                the gossip network mixing every 4th ADMM
                                iteration, each worker missing a round
                                with probability 0.1
    --consensus trimmed:f=1:rounds=3:byz=3:attack=signflip@ring:4
                                worker 3 sends -x; receivers trim it

``--topology`` (``ring[:d] | torus:RxC | hypercube | geometric:r[:seed]
| full``, ``+``-joined for a time-varying cycle) swaps the gossip graph,
and with the default ``--consensus exact`` implies gossip over it
(``--rounds`` rounds); ``--degree``/``--rounds`` fill the segments a
spec leaves out; ``--wire-dtype bf16|f16`` narrows the link payloads;
``--no-compress`` runs B serial rounds instead of one H^B schedule;
``--membership 1101`` masks the graph to the active workers.

``--checkpoint-dir D`` saves the training state in ``repro``'s checkpoint
schema after every ``--checkpoint-every`` layers; ``--stop-after-layer
l`` completes layer l, checkpoints and exits, and ``--resume`` continues
from the deepest complete checkpoint in D, bit for bit like the
uninterrupted run.  ``--guard-divergence`` rolls a diverging layer back
to the last checkpoint with a perturbed key (``--max-rollbacks`` times
at most)::

    python -m repro_torch.launch.train_dssfn --device cpu --layers 3 \\
        --checkpoint-dir /tmp/ck --stop-after-layer 1
    python -m repro_torch.launch.train_dssfn --device cpu --layers 3 \\
        --checkpoint-dir /tmp/ck --resume

It runs on ``cuda`` unless ``--device cpu`` is given (the CPU takes the
kernels' plain versions).  The data is the planted-teacher problem of
``repro_torch.data`` drawn from ``--seed`` and the random matrices from
``--seed + 1``, on the run's device; the checkpoints store that seed's
threefry key, ``PRNGKey(seed + 1)``, as ``repro``'s launcher does; every
rank makes the same data and keeps its workers' shards.  The result dict
has ``repro``'s keys, plus ``device``, ``kernel_launches`` (the CUDA
kernel launches per kernel during training and test evaluation, summed
over the ranks) and ``consensus_error`` (each layer's ADMM consensus
error at its last iteration; None without traces); a mesh run adds
``ranks``, ``dist_backend``, its ``collective_counts`` and bytes summed
over the ranks, and ``per_rank`` (train time, host seconds in the
transport and of those the staged copies' wait for the card, launches).  Under ``--backend both`` checkpoints go to
``<dir>/simulated`` and ``<dir>/mesh``.  ``--export-artifact``
writes the trained stack in ``repro``'s serving format, which
``repro_torch.launch.serve_dssfn`` (or ``repro``'s) serves;
``--export-features`` records a frozen feature-extractor spec in it.
``--use-kernels`` and ``--no-host-mesh`` are accepted so that
``repro``'s command lines run, and land in the result's ``config``; they
change nothing (the card always launches the kernels, and no devices
are faked).
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
        help="where the workers run: simulated (one process), mesh (W "
        "ranks, --ranks) or both (and their parity)",
    )
    ap.add_argument(
        "--ranks", type=int, default=None,
        help="W, the mesh's processes (default: one worker a rank, W = M); "
        "W must divide M",
    )
    ap.add_argument(
        "--dist-backend", default=None, choices=["nccl", "gloo"],
        help="process-group backend of the mesh (default: nccl on the card, "
        "gloo on the CPU)",
    )
    ap.add_argument(
        "--consensus", default="exact",
        help="consensus spec (dssfn.parse_spec grammar): exact | "
        "gossip[:B[:d]] | quantized[:bits] | lossy[:p[:B[:d]]] | "
        "stale[:delay] | async[:key=value...] | trimmed[:key=value...] | "
        "median[:key=value...] | clipped[:tau][:key=value...], optionally "
        "'@topology' and ':wire=bf16'",
    )
    ap.add_argument(
        "--topology", default=None,
        help="communication graph for the gossip policy: ring[:d] | "
        "torus:RxC | hypercube | geometric:r[:seed] | full ('+'-joined "
        "specs cycle round by round).  With the default --consensus exact "
        "this implies gossip over the graph (--rounds rounds).",
    )
    ap.add_argument(
        "--partition", default="iid",
        help="worker data partition: iid | noniid[:alpha] (alpha in (0,1] "
        "= label-skew fraction per shard)",
    )
    # default=None so build_policy can tell an explicit --degree from the
    # implicit 2 and reject --degree with --topology.
    ap.add_argument(
        "--degree", type=int, default=None,
        help="gossip ring degree d (default 2; incompatible with --topology)",
    )
    ap.add_argument("--rounds", type=int, default=10, help="gossip rounds B")
    ap.add_argument(
        "--wire-dtype", default=None,
        choices=["float32", "bfloat16", "float16", "f32", "bf16", "f16"],
        help="link payload width for the gossip policy: messages are cast "
        "once before the wire and accumulated in f32",
    )
    ap.add_argument(
        "--no-compress", action="store_true",
        help="run gossip rounds as B serial exchange schedules instead of "
        "the default ONE compressed H^B schedule (power_schedule)",
    )
    ap.add_argument(
        "--use-kernels",
        action="store_true",
        help="accepted for repro's command lines and recorded in the "
        "result's config; changes nothing: on the card every Gram product "
        "always launches the CUDA kernels (gram, propagate_gram), at any "
        "shape, and the CPU always takes their plain versions",
    )
    ap.add_argument(
        "--membership", default=None,
        help="active-worker slot mask as a 1/0 string (e.g. 1101): masks "
        "the gossip graph to the active workers",
    )
    ap.add_argument(
        "--checkpoint-dir",
        default=None,
        help="directory for elastic-resume checkpoints (state saved after "
        "each --checkpoint-every layers); default: no checkpointing",
    )
    ap.add_argument(
        "--checkpoint-every",
        type=int,
        default=1,
        help="checkpoint after every N completed layers (with "
        "--checkpoint-dir)",
    )
    ap.add_argument(
        "--resume",
        action="store_true",
        help="restore the latest --checkpoint-dir checkpoint and continue "
        "from its next layer (bit-exact vs the uninterrupted run)",
    )
    ap.add_argument(
        "--stop-after-layer",
        type=int,
        default=None,
        help="complete this layer index, checkpoint, and exit (the crash "
        "half of a kill/resume drill)",
    )
    ap.add_argument(
        "--guard-divergence",
        action="store_true",
        help="monitor each layer solve for divergence (non-finite or "
        "exploding objective) and roll back to the last complete "
        "checkpoint with a perturbed RNG key instead of training on",
    )
    ap.add_argument(
        "--max-rollbacks",
        type=int,
        default=2,
        help="divergence-rollback budget before the run raises "
        "(with --guard-divergence)",
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
    ap.add_argument(
        "--export-features",
        default=None,
        help="frozen feature-extractor spec recorded in the exported "
        "artifact (identity | rff:D[:seed] | relu:D[:seed]); the engine "
        "applies it to raw requests before the stack, so it is only "
        "meaningful when training ran on pre-extracted features",
    )
    ap.add_argument("--out", default=None, help="optional JSON results path")
    ap.add_argument(
        "--device", default=None,
        help="torch device to train on (default: cuda, which must exist)",
    )
    ap.add_argument(
        "--no-host-mesh",
        action="store_true",
        help="accepted for repro's command lines and recorded in the "
        "result's config; changes nothing: the port fakes no devices "
        "(--backend mesh spawns --ranks processes on this host instead)",
    )
    return ap.parse_args(argv)


def _launch_counts() -> dict[str, int]:
    from repro_torch.kernels import gram, matmul_relu, propagate_gram

    return {
        "gram": gram.launch_count(),
        "propagate_gram": propagate_gram.launch_count(),
        "matmul_relu": matmul_relu.launch_count(),
    }


def build_policy(args):
    """--consensus + --topology -> ConsensusPolicy via the unified
    ``dssfn.parse_spec`` grammar.  --degree/--rounds fill any segment the
    spec leaves out; --topology (or the spec's own ``@graph`` half) swaps
    the gossip graph, and with the default ``--consensus exact`` it
    implies ``gossip`` over that graph."""
    from dataclasses import fields, replace

    from repro_torch.core.policy import parse_policy
    from repro_torch.core.topology import parse_topology
    from repro_torch.dssfn import parse_spec

    consensus, sep, spec_topo = args.consensus.partition("@")
    if sep and args.topology:
        raise ValueError(
            f"--consensus {args.consensus!r} already names an '@topology'; "
            "drop --topology"
        )
    topo_spec = spec_topo if sep else args.topology
    topo = parse_topology(topo_spec) if topo_spec else None
    if topo is not None and args.degree is not None:
        raise ValueError(
            "--degree configures the default ring; pass either --degree or "
            "--topology (ring degree spells ring:d), not both"
        )
    if topo is not None and consensus == "exact":
        consensus = "gossip"
    kw = dict(
        degree=args.degree if args.degree is not None else 2,
        rounds=args.rounds,
    )
    if sep:
        policy = parse_spec(f"{consensus}@{spec_topo}", **kw)
    else:
        policy = parse_policy(consensus, topology=topo, **kw)
    if args.no_compress and any(f.name == "compress" for f in fields(policy)):
        policy = replace(policy, compress=False)
    return policy


def _config(args):
    from repro_torch.core import ssfn

    return ssfn.SSFNConfig(
        input_dim=args.input_dim,
        num_classes=args.classes,
        num_layers=args.layers,
        hidden=args.hidden,
        admm_iters=args.admm_iters,
    )


def _data(args, dev):
    """The run's planted-teacher data from ``--seed``, on ``dev``."""
    import torch

    from repro_torch.data import make_classification

    return make_classification(
        torch.Generator(device=dev).manual_seed(args.seed),
        num_train=args.train,
        num_test=args.test,
        input_dim=args.input_dim,
        num_classes=args.classes,
    )


def _spec(kind: str, args, cfg, *, mesh=None):
    from repro_torch import dssfn

    ckpt_dir = args.checkpoint_dir
    if ckpt_dir is not None and args.backend == "both":
        # The simulated and mesh runs must not resume each other's state.
        ckpt_dir = os.path.join(ckpt_dir, kind)
    return dssfn.TrainSpec(
        cfg=cfg, backend=kind, workers=args.workers, policy=build_policy(args),
        wire_dtype=args.wire_dtype, trace_every=args.trace_every,
        membership=args.membership, mesh=mesh,
        checkpoint_dir=ckpt_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        stop_after_layer=args.stop_after_layer,
        guard_divergence=args.guard_divergence,
        max_rollbacks=args.max_rollbacks,
    )


def _train(kind: str, args, data, xw, tw, cfg, generator, *, mesh=None) -> dict:
    """One train through the facade, timed: the run's result keys (without
    ``kernel_launches``) plus ``params``; the test accuracy only where
    the run reports (a mesh's rank 0)."""
    from repro_torch import dssfn
    from repro_torch._device import synchronize

    t0 = time.perf_counter()
    result = dssfn.train(_spec(kind, args, cfg, mesh=mesh), xw, tw, generator)
    params, log, backend = result.params, result.log, result.backend
    synchronize(params.o[-1].device)
    wall = time.perf_counter() - t0
    reports = mesh is None or mesh.rank == 0
    acc = dssfn.evaluate(result, data.x_test, data.y_test) if reports else None
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
        "consensus_error": (
            log.consensus_error[:, -1].tolist() if log.consensus_error.size else None
        ),
        "params": params,
    }


def train_one(kind: str, args, data, xw, tw, cfg, generator) -> dict:
    """The simulated run, in this process."""
    before = _launch_counts()
    run = _train(kind, args, data, xw, tw, cfg, generator)
    after = _launch_counts()
    run["kernel_launches"] = {k: after[k] - before[k] for k in after}
    return run


def _train_rank(group, args) -> dict:
    """One rank of the mesh run: the run's data and R made again from the
    seeds, this rank's shards kept, the train through the facade on a
    ``MeshBackend`` of ``group``.  Rank 0's result carries the run's keys
    and its readouts and R (as numpy); every rank's its train time, its
    host seconds in the transport, its collectives and its launches."""
    import torch

    from repro_torch.data import partition_by_spec

    dev = group.device
    data = _data(args, dev)
    xw, tw = partition_by_spec(
        data.x_train, data.t_train, args.workers, args.partition, rows=group.rows
    )
    generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
    group.transport.reset()
    before = _launch_counts()
    run = _train("mesh", args, data, xw, tw, _config(args), generator, mesh=group)
    after = _launch_counts()
    params = run.pop("params")
    stats = group.transport.stats
    out = {
        "rank": group.rank,
        "wall_time_s": run["wall_time_s"],
        "transport_host_s": stats.host_s,
        "transport_sync_s": stats.sync_s,
        "collective_counts": dict(stats.counts),
        "collective_bytes": dict(stats.bytes),
        "messages": stats.messages,
        "kernel_launches": {k: after[k] - before[k] for k in after},
    }
    if group.rank == 0:
        out["run"] = run
        out["params"] = (
            [o.detach().cpu().numpy() for o in params.o],
            [r.detach().cpu().numpy() for r in params.r],
        )
    return out


def _summed(dicts) -> dict:
    total: dict = {}
    for d in dicts:
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    return total


def mesh_one(args, dev) -> dict:
    """The mesh run: W ranks spawned on this host (or this process alone
    for W = 1, or this process as one rank of a ``torchrun`` launch), and
    rank 0's run keys with the ranks' launches and collectives summed."""
    import torch

    from repro_torch.core.ssfn import SSFNParams
    from repro_torch.launch import mesh as mesh_lib

    ranks = args.ranks or args.workers
    if args.workers % ranks:
        raise ValueError(f"--ranks {ranks} must divide --workers {args.workers}")
    if mesh_lib._in_torchrun():
        group = mesh_lib.make_worker_group(
            args.workers, ranks if args.ranks else None, args.dist_backend, device=dev)
        mine = _train_rank(group, args)
        per_rank = _gather_objects(group, mine)
    elif ranks == 1:
        group = mesh_lib.make_worker_group(args.workers, 1, args.dist_backend, device=dev)
        per_rank = [_train_rank(group, args)]
    else:
        if dev.type == "cuda":
            from repro_torch.kernels import _build

            # One build before the ranks start, not one nvcc per rank.
            _build.build_all()
        per_rank = mesh_lib.spawn_workers(
            _train_rank, ranks, args, num_workers=args.workers,
            backend=args.dist_backend, device=dev,
        )
    head = per_rank[0]
    run = head["run"]
    o, r = head["params"]
    run["params"] = SSFNParams(
        o=tuple(torch.from_numpy(a).to(dev) for a in o),
        r=tuple(torch.from_numpy(a).to(dev) for a in r),
    )
    run["ranks"] = len(per_rank)
    run["dist_backend"] = args.dist_backend or mesh_lib.default_dist_backend(dev)
    run["kernel_launches"] = _summed(p["kernel_launches"] for p in per_rank)
    run["collective_counts"] = _summed(p["collective_counts"] for p in per_rank)
    run["collective_bytes"] = _summed(p["collective_bytes"] for p in per_rank)
    run["messages"] = sum(p["messages"] for p in per_rank)
    run["per_rank"] = [
        {k: p[k] for k in ("rank", "wall_time_s", "transport_host_s", "transport_sync_s",
                           "messages", "kernel_launches", "collective_counts")}
        for p in per_rank
    ]
    return run


def _gather_objects(group, mine: dict) -> list:
    """Every rank's ``mine`` (picklable) on every rank, in rank order,
    through the group's transport (sizes first, then the padded bytes)."""
    import pickle

    import torch

    blob = torch.frombuffer(bytearray(pickle.dumps(mine)), dtype=torch.uint8)
    dev = group.device if group.dist_backend == "nccl" else torch.device("cpu")
    size = torch.tensor([blob.numel()], dtype=torch.int64, device=dev)
    sizes = group.transport.all_gather(size).tolist()
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[: blob.numel()] = blob.to(dev)
    rows = group.transport.all_gather(padded[None]).cpu()
    return [pickle.loads(rows[i, :n].numpy().tobytes()) for i, n in enumerate(sizes)]


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.data import partition_by_spec
    from repro_torch.launch import mesh as mesh_lib

    dev = resolve_device(args.device)
    kinds = ["simulated", "mesh"] if args.backend == "both" else [args.backend]
    # Under torchrun every rank runs this; rank 0 alone trains the
    # simulated run and reports.
    lead = int(os.environ.get("RANK", "0")) == 0 if mesh_lib._in_torchrun() else True
    if lead:
        print(f"device: {dev}", flush=True)

    results: dict = {"config": vars(args), "device": str(dev), "runs": []}
    # Predicted mixing behaviour of the selected graph (paper §III).
    topo = getattr(build_policy(args), "topology", None)
    if topo is not None and lead:
        results["topology"] = {
            "spec": topo.describe(),
            "spectral_gap": topo.spectral_gap(args.workers),
            "edges_per_node": topo.edges_per_node(args.workers),
            "rounds_for_tolerance_1e6": topo.rounds_for_tolerance(
                args.workers, 1e-6
            ),
        }
        print(
            f"topology {topo.describe()}: gap="
            f"{results['topology']['spectral_gap']:.3f} "
            f"edges/node={results['topology']['edges_per_node']} "
            f"B*(1e-6)={results['topology']['rounds_for_tolerance_1e6']}",
            flush=True,
        )
    params_by_kind = {}
    for kind in kinds:
        if kind == "mesh":
            run = mesh_one(args, dev)
        elif lead:
            data = _data(args, dev)
            xw, tw = partition_by_spec(
                data.x_train, data.t_train, args.workers, args.partition
            )
            generator = torch.Generator(device=dev).manual_seed(args.seed + 1)
            run = train_one(kind, args, data, xw, tw, _config(args), generator)
            del data, xw, tw
        else:
            continue
        params_by_kind[kind] = run.pop("params")
        results["runs"].append(run)
        obj = run["final_objective"]
        obj_str = f"{obj:.4f}" if obj is not None else "n/a (trace_every=0)"
        if lead:
            print(
                f"{run['backend']} on {dev}: wall={run['wall_time_s']:.2f}s "
                f"acc={run['test_accuracy']:.3f} obj={obj_str} "
                f"comm={run['comm_scalars']} scalars "
                f"kernel_launches={run['kernel_launches']}",
                flush=True,
            )
    if not lead:
        return results

    if len(params_by_kind) == 2:
        gaps = [
            float(torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(a).clamp_min(1e-30))
            for a, b in zip(params_by_kind["simulated"].o, params_by_kind["mesh"].o)
        ]
        objs = [r["final_objective"] for r in results["runs"]]
        results["parity"] = {"max_readout_rel_gap": max(gaps)}
        if None not in objs:  # trace_every=0 has no objective to compare
            results["parity"]["rel_objective_gap"] = abs(objs[0] - objs[1]) / max(
                abs(objs[0]), 1e-30
            )
        obj_str = (
            f"{results['parity']['rel_objective_gap']:.2e}"
            if "rel_objective_gap" in results["parity"] else "n/a"
        )
        print(
            f"parity simulated-vs-mesh: max readout gap={max(gaps):.2e}, "
            f"objective gap={obj_str}",
            flush=True,
        )

    params = params_by_kind[kinds[0]]
    if args.export_artifact:
        from repro_torch.serve import export_artifact

        export_artifact(
            args.export_artifact,
            params,
            features=args.export_features,
            source={
                "trained_by": "repro_torch.launch.train_dssfn",
                "backend": kinds[0],
                "consensus": args.consensus,
                "workers": args.workers,
                "seed": args.seed,
                "device": str(dev),
            },
        )
        results["export"] = {
            "path": args.export_artifact,
            "source_kind": kinds[0],
            "num_layers": len(params.o) - 1,
        }
        print(
            f"exported serving artifact -> {args.export_artifact} "
            f"(from the {kinds[0]} run, {len(params.o) - 1} layers)",
            flush=True,
        )

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
