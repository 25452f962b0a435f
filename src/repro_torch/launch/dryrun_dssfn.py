"""Dry run of the PAPER'S TECHNIQUE on the production mesh: the dSSFN
layer-wise readout solve, distributed over all 256 (or 512) H100s of the
plan, one ADMM worker a GPU.

Two schedules are compared:
  - admm:  the paper's consensus-ADMM (eq. 11) — K all-reduces of (Q, n)
  - gram:  beyond-paper one-shot Gram-sharing — one all-reduce of
           (n^2 + Q*n)

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun_dssfn \\
        [--n 4096] [--q 32] [--tokens 1048576] [--iters 100] [--multi-pod] \\
        [--mode admm|gram] [--device cuda|cpu]

Port of ``repro/launch/dryrun_dssfn.py``.  The reference lowers the
solve under ``shard_map`` for 256 or 512 placeholder devices and reads the
compiled HLO.  The port RUNS one rank's share of the solve for real, on
``--device`` (the card by default; ``cpu`` here): ``core/readout``'s
``admm_solve_sharded`` or ``gram_share_solve_sharded`` on seeded
(n, J / devices) and (Q, J / devices) blocks, under
``launch/cost_analysis.py`` (FLOPs, traffic and the live peak; the
``gram`` kernel's launch is credited with its plain version's work),
with a ``CountingTransport`` in place of the rank group's ``Transport``:
it records each all-reduce (op, bytes, group size) and returns x * size,
as if every rank held the same block, so a mean keeps the local values.
A real run and not a fake trace, because ``admm.guarded_cholesky`` reads
each factor's health on the host (one host sync a try), which a fake
tensor cannot answer; one rank's share at the defaults (n = 4096,
J = 4096 a rank) is small.

The result has ``repro``'s keys (``flops_per_device``,
``hbm_bytes_per_device``, ``collective_wire_bytes``,
``collective_by_type``, ``peak_bytes_per_device``, ``roofline``), the
roofline over ``launch/mesh.HARDWARE`` (a group of 256 spans nodes, so
the collective term is at the InfiniBand rate), plus the counts, the
device and the solve's wall time.  One difference in the schedule: the
port's ADMM issues K all-reduces of (Q, n) and ONE of (K,) at the end
(``admm_solve_sharded`` sums its objective trace once), where ``repro``
issues K scalar psums, one an iteration; the same sums.

``lower_solver`` has no counterpart (nothing lowers): :func:`dryrun_solver`
takes its place.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch

from repro_torch._device import resolve_device, synchronize
from repro_torch.core.readout import admm_solve_sharded, gram_share_solve_sharded
from repro_torch.launch.cost_analysis import CountingTransport, analyze_call
from repro_torch.launch.dryrun import roofline_terms
from repro_torch.launch.mesh import make_production_mesh

MODES = ("admm", "gram")


def _solver(mode: str, *, q: int, iters: int, transport):
    if mode == "admm":
        return functools.partial(admm_solve_sharded, mu=1e-2, eps_radius=2.0 * q,
                                 num_iters=iters, group=transport)
    if mode == "gram":
        return functools.partial(gram_share_solve_sharded, eps_radius=2.0 * q, group=transport)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def solve_one_rank(mode: str, y_local: torch.Tensor, t_local: torch.Tensor, *, size: int,
                   iters: int):
    """One rank's share of the solve over ``size`` ranks that hold the same
    block: ``(z, analysis, transport)``, the analysis with the counting
    transport's collectives."""
    transport = CountingTransport(size)
    fn = _solver(mode, q=t_local.shape[0], iters=iters, transport=transport)
    out, analysis = analyze_call(fn, y_local, t_local)
    analysis.collectives.extend(transport.collectives)
    z = out.z if mode == "admm" else out
    return z, analysis, transport


def dryrun_solver(mode: str, *, n: int, q: int, j_total: int, iters: int,
                  multi_pod: bool = False, device=None) -> dict:
    plan = make_production_mesh(multi_pod=multi_pod)
    num = plan.size
    if j_total % num:
        raise ValueError(f"{j_total} samples do not split over {num} devices")
    j = j_total // num
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    y = torch.randn((n, j), generator=gen, device=dev)
    t = torch.randn((q, j), generator=gen, device=dev)
    z, a, transport = solve_one_rank(mode, y, t, size=num, iters=iters)
    # The solve again, unrecorded, for its wall time.
    fn = _solver(mode, q=q, iters=iters, transport=CountingTransport(num))
    synchronize(dev)
    t0 = time.perf_counter()
    fn(y, t)
    synchronize(dev)
    wall = time.perf_counter() - t0
    terms = roofline_terms(a.flops, a.traffic_bytes, a.collectives)
    arg = sum(x.numel() * x.element_size() for x in (y, t))
    return {
        "mode": mode, "n": n, "q": q, "j_total": j_total, "iters": iters,
        "mesh": plan.name, "devices": num, "j_per_device": j,
        "device": str(dev) if dev.type != "cuda" else torch.cuda.get_device_name(dev),
        "flops_per_device": a.flops,
        "hbm_bytes_per_device": a.traffic_bytes,
        "collective_wire_bytes": a.collective_wire_bytes,
        "collective_by_type": a.collective_by_type(),
        "collective_counts": a.collective_counts(),
        "collective_bytes": dict(transport.stats.bytes),
        "peak_bytes_per_device": arg + a.peak_live_bytes,
        "kernel_launches": {k.removeprefix("kernel:"): {"calls": v.calls, "flops": v.flops}
                            for k, v in a.by_op.items() if k.startswith("kernel:")},
        "solve_wall_s": wall,
        "z_finite": bool(torch.isfinite(z).all()),
        "roofline": {**terms, "dominant": max(terms, key=terms.get)},
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--q", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=1048576)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default=None, choices=list(MODES))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be available)")
    ap.add_argument("--out", default="experiments/dssfn_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    results = []
    for mode in ([args.mode] if args.mode else list(MODES)):
        res = dryrun_solver(
            mode, n=args.n, q=args.q, j_total=args.tokens, iters=args.iters,
            multi_pod=args.multi_pod, device=args.device,
        )
        tag = f"{mode}_n{args.n}_q{args.q}_K{args.iters}_{res['mesh']}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=2)
        r = res["roofline"]
        print(
            f"{tag}: compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
            f"coll={r['collective_s']:.3e}s dom={r['dominant']} "
            f"wire={res['collective_wire_bytes']:.3e}B "
            f"all-reduces={res['collective_counts'].get('all-reduce', 0)} "
            f"solve={res['solve_wall_s']:.3f}s on {res['device']}",
            flush=True,
        )
        if mode == "admm":
            print(f"{tag}: {args.iters} all-reduces of (Q, n) and one of (K,) for the "
                  f"objective trace, where repro issues {args.iters} scalar psums",
                  flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
