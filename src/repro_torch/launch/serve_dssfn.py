"""dSSFN serving launcher: load an exported artifact, serve a request
stream through the bucketed engine + micro-batcher on the card.

    python -m repro_torch.launch.serve_dssfn --artifact /tmp/stack \
        --requests 200 --request-size 1 --batch-bucket 1,8,32 \
        --max-wait-us 200

The artifact may come from either package's ``export_artifact`` (or
``repro``'s ``train_dssfn --export-artifact``).  The launcher drives a
seeded synthetic request stream through
:class:`repro_torch.serve.MicroBatcher` and reports per-request p50/p99
latency, throughput, coalescing stats, the engine's bucket-program counts
(no lowering may happen in the timed stream, asserted) and
``kernel_launches``, the CUDA ``matmul_relu`` launches the timed stream
made.  It runs on ``cuda`` unless ``--device cpu`` is given.

``--runtime`` serves through :class:`repro_torch.serve.ServeRuntime`
instead: bounded admission, deadlines, retry + circuit breaker, a
lifecycle with ``drain()``.  With ``--manual-clock``, ``--chaos`` (a
``parse_chaos`` spec) and ``--poison-rate`` it is the chaos drill, which
replays ``repro``'s drill from the same seed; the run reports the
terminal counts, the runtime's snapshot, ``degraded_reasons``
(``kernels-disabled`` on the CPU once the breaker has opened, as
``repro`` reports it; on the card the route stays the kernel) and
``kernel_launches``, and checks that every handle reached a terminal
state::

    python -m repro_torch.launch.serve_dssfn --artifact /tmp/stack \
        --runtime --manual-clock --requests 400 --max-pending-samples 64 \
        --deadline-ms 50 --chaos fail=0.3:burst=4:seed=7

``--features`` overrides nothing: the artifact records its own extractor
spec; the flag only *verifies* the artifact matches what the operator
expects.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--artifact", required=True,
        help="artifact directory written by export_artifact",
    )
    ap.add_argument(
        "--batch-bucket",
        default=None,
        help="comma-separated shape-bucket ladder (e.g. 1,8,32); request "
        "batches pad to the smallest fitting bucket (default: powers of "
        "two up to 128)",
    )
    ap.add_argument(
        "--max-wait-us",
        type=float,
        default=0.0,
        help="micro-batching admission: flush once the oldest queued "
        "request has waited this long (0 = never hold, flush on every "
        "submit)",
    )
    ap.add_argument(
        "--max-batch",
        type=int,
        default=None,
        help="micro-batching admission: flush once this many samples are "
        "queued (default: the largest bucket)",
    )
    ap.add_argument(
        "--features",
        default=None,
        help="expected feature-extractor spec; serving refuses to start "
        "if the artifact records a different one (deploy-time guard)",
    )
    ap.add_argument(
        "--requests", type=int, default=100,
        help="synthetic request count to drive through the batcher",
    )
    ap.add_argument(
        "--request-size", type=int, default=1,
        help="samples per request (columns; 1 = single-sample requests)",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device to serve on (default: cuda, which must exist)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="optional JSON results path")
    ap.add_argument(
        "--save-logits", default=None,
        help="optional .npz path for the served stream: 'requests' (P, N) "
        "and 'logits' (Q, N), columns in request order (with --runtime, "
        "the completed requests only)",
    )

    rt = ap.add_argument_group("hardened runtime (--runtime)")
    rt.add_argument(
        "--runtime", action="store_true",
        help="serve through ServeRuntime (bounded admission, deadlines, "
        "retry + circuit breaker, drain) instead of the bare batcher",
    )
    rt.add_argument(
        "--manual-clock", action="store_true",
        help="drive the runtime on a deterministic ManualClock (ticks "
        "between submits) — the reproducible chaos-drill mode",
    )
    rt.add_argument(
        "--max-pending-samples", type=int, default=None,
        help="admission bound: load-shed submits beyond this many queued "
        "samples (default: 8x max_batch)",
    )
    rt.add_argument(
        "--max-pending-requests", type=int, default=None,
        help="admission bound on queued request count",
    )
    rt.add_argument(
        "--deadline-ms", type=float, default=None,
        help="default per-request deadline; expired requests are shed "
        "pre-flush, never served",
    )
    rt.add_argument(
        "--flush-every-us", type=float, default=None,
        help="wall-clock timer thread flush interval (ignored with "
        "--manual-clock; ticks are explicit there)",
    )
    rt.add_argument("--retries", type=int, default=2,
                    help="engine retries per batch before failure handling")
    rt.add_argument("--breaker-threshold", type=int, default=3,
                    help="consecutive batch failures that open the breaker")
    rt.add_argument("--breaker-cooldown-ms", type=float, default=250.0,
                    help="open -> half-open cooldown")
    rt.add_argument(
        "--chaos", default=None,
        help="seeded fault-injection spec, e.g. fail=0.3:burst=4:seed=7 "
        "(see repro_torch.serve.parse_chaos)",
    )
    rt.add_argument(
        "--poison-rate", type=float, default=0.0,
        help="fraction of synthetic requests poisoned with NaN (must be "
        "rejected at admission)",
    )
    rt.add_argument(
        "--arrival-us", type=float, default=0.0,
        help="inter-arrival time of the synthetic stream (manual clock "
        "advances by this per submit; wall clock sleeps)",
    )
    rt.add_argument(
        "--tick-every", type=int, default=4,
        help="manual-clock mode: call runtime.tick() every N submits",
    )
    return ap.parse_args(argv)


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(p / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _write_out(args, results: dict) -> None:
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


def _save_logits(path: str, xs, logits) -> None:
    """'requests' (P, N) and 'logits' (Q, N), columns in request order."""
    import numpy as np
    import torch

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        requests=torch.cat(xs, dim=1).numpy(),
        logits=torch.cat(logits, dim=1).float().cpu().numpy(),
    )


def _drive_runtime(args, engine, xs, rng) -> dict:
    """The hardened-runtime drive path: a synthetic open-loop stream with
    optional poison, chaos and deadlines; every handle must end terminal
    and the runtime must drain to STOPPED."""
    from repro_torch.kernels.matmul_relu import launch_count
    from repro_torch.serve import ManualClock, ServeRuntime, WallClock, parse_chaos

    clock = ManualClock() if args.manual_clock else WallClock()
    chaos = parse_chaos(args.chaos) if args.chaos else None
    runtime = ServeRuntime(
        engine,
        clock=clock,
        max_batch=args.max_batch,
        max_pending_samples=args.max_pending_samples,
        max_pending_requests=args.max_pending_requests,
        default_deadline_s=(
            args.deadline_ms * 1e-3 if args.deadline_ms is not None else None
        ),
        flush_interval_s=(
            args.flush_every_us * 1e-6
            if args.flush_every_us is not None else None
        ),
        max_retries=args.retries,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_ms * 1e-3,
        chaos=chaos,
    ).start()
    if chaos is not None:
        print(chaos.describe(), flush=True)

    launches_before = launch_count()
    t0 = time.perf_counter()
    handles = []
    for i, x in enumerate(xs):
        if args.poison_rate and rng.random() < args.poison_rate:
            x = x.clone()
            x[0, 0] = float("nan")
        handles.append(runtime.submit(x))
        if args.arrival_us:
            clock.sleep(args.arrival_us * 1e-6)
        if args.manual_clock and args.tick_every and (i + 1) % args.tick_every == 0:
            runtime.tick()
    runtime.drain()
    wall = time.perf_counter() - t0
    kernel_launches = launch_count() - launches_before

    if not all(h.done() for h in handles):
        raise RuntimeError("non-terminal handles after drain")
    snap = runtime.snapshot()
    if snap["state"] != "STOPPED":
        raise RuntimeError(f"drain left state {snap['state']}")

    completed = sorted(h.latency_s for h in handles if h.ok())
    info = engine.cache_info()
    # Bisection may use smaller buckets mid-stream; the bound that must
    # hold is still one program per (bucket, dtype).
    if info["lowerings"] > 2 * len(engine.buckets):
        raise RuntimeError(
            f"{info['lowerings']} lowerings for {len(engine.buckets)} buckets"
        )
    results = {
        "artifact": engine.artifact.describe(),
        "device": str(engine.device),
        "mode": "runtime",
        "clock": "manual" if args.manual_clock else "wall",
        "chaos": args.chaos,
        "requests": args.requests,
        "request_size": args.request_size,
        "wall_time_s": wall,
        "completed": sum(h.ok() for h in handles),
        "failed": sum(h.status == "failed" for h in handles),
        "rejected": sum(h.status == "rejected" for h in handles),
        "expired": sum(h.status == "expired" for h in handles),
        "latency_ms": {
            "p50": _percentile(completed, 50) * 1e3,
            "p99": _percentile(completed, 99) * 1e3,
        },
        "kernel_launches": kernel_launches,
        "degraded_reasons": snap["degraded_reasons"],
        "snapshot": snap,
        "compile": info,
    }
    s = snap["stats"]
    print(
        f"runtime drill on {engine.device}: {results['completed']} completed / "
        f"{results['failed']} failed / {results['rejected']} rejected / "
        f"{results['expired']} expired of {args.requests} "
        f"(shed_rate={snap['shed_rate']:.3f} "
        f"deadline_hit_rate={snap['deadline_hit_rate']:.3f}) "
        f"breaker opens={s['breaker_opens']} closes={s['breaker_closes']} "
        f"retries={s['retries']} quarantined={s['quarantined']} "
        f"final_state={snap['state']} degraded={snap['degraded_reasons']} "
        f"kernel_launches={kernel_launches}",
        flush=True,
    )
    if args.save_logits:
        done = [(x, h) for x, h in zip(xs, handles) if h.ok()]
        if done:
            _save_logits(args.save_logits, [x for x, _ in done],
                         [h.result() for _, h in done])
    _write_out(args, results)
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np
    import torch

    from repro_torch._device import synchronize
    from repro_torch.kernels.matmul_relu import launch_count
    from repro_torch.serve import MicroBatcher, ServeEngine, load_artifact

    artifact = load_artifact(args.artifact)
    if args.features is not None:
        expect = None if args.features == "identity" else args.features
        if artifact.features != expect:
            raise SystemExit(
                f"artifact records features="
                f"{(artifact.features or 'identity')!r}, operator "
                f"expected {args.features!r} — refusing to serve"
            )

    buckets = None
    if args.batch_bucket:
        buckets = tuple(int(b) for b in args.batch_bucket.split(","))
    engine = ServeEngine(artifact, buckets=buckets, device=args.device)
    print(engine.describe(), flush=True)

    max_batch = args.max_batch if args.max_batch else engine.max_batch

    rng = np.random.default_rng(args.seed)
    p_req = (
        engine.request_dim
        if engine.request_dim is not None
        else artifact.input_dim
    )
    xs = [
        torch.from_numpy(
            rng.standard_normal((p_req, args.request_size)).astype(np.float32)
        )
        for _ in range(args.requests)
    ]

    # Warmup: run every bucket the coalescer can produce once, off the
    # clock (builds the kernel library and fills the program cache).
    for b in engine.buckets:
        if b <= max_batch or b == engine.bucket_for(args.request_size):
            engine.forward(torch.zeros((p_req, b), dtype=torch.float32))
    synchronize(engine.device)
    warm_lowerings = engine.lowerings

    if args.runtime:
        return _drive_runtime(args, engine, xs, rng)

    batcher = MicroBatcher(
        engine, max_batch=args.max_batch, max_wait_us=args.max_wait_us
    )
    warm_stats = dict(batcher.stats)
    launches_before = launch_count()

    t0 = time.perf_counter()
    handles = [batcher.submit(x) for x in xs]
    batcher.flush()
    wall = time.perf_counter() - t0
    kernel_launches = launch_count() - launches_before
    if not all(h.done() for h in handles):
        raise RuntimeError("requests left unserved after the final flush")

    lats = sorted(h.latency_s for h in handles)
    total_samples = args.requests * args.request_size
    info = engine.cache_info()
    # The program-cache contract: warmup filled every reachable bucket;
    # the timed stream itself must not add any.
    if info["lowerings"] != warm_lowerings:
        raise RuntimeError(
            f"timed stream triggered {info['lowerings'] - warm_lowerings} "
            f"extra lowerings (compile-once contract broken)"
        )
    if info["lowerings"] > len(engine.buckets):
        raise RuntimeError(
            f"{info['lowerings']} lowerings for {len(engine.buckets)} buckets"
        )

    results = {
        "artifact": artifact.describe(),
        "device": str(engine.device),
        "buckets": list(engine.buckets),
        "max_wait_us": args.max_wait_us,
        "requests": args.requests,
        "request_size": args.request_size,
        "completed": sum(h.ok() for h in handles),
        "wall_time_s": wall,
        "throughput_samples_per_s": total_samples / max(wall, 1e-12),
        "latency_ms": {
            "p50": _percentile(lats, 50) * 1e3,
            "p99": _percentile(lats, 99) * 1e3,
            "max": lats[-1] * 1e3,
        },
        "batches": batcher.stats["batches"] - warm_stats["batches"],
        "mean_batch_size": batcher.mean_batch_size(since=warm_stats),
        "kernel_launches": kernel_launches,
        "compile": info,
    }
    print(
        f"served {args.requests} requests ({total_samples} samples) on "
        f"{engine.device} in {wall * 1e3:.1f} ms: "
        f"p50={results['latency_ms']['p50']:.3f} ms "
        f"p99={results['latency_ms']['p99']:.3f} ms "
        f"throughput={results['throughput_samples_per_s']:.0f} samples/s "
        f"batches={results['batches']} "
        f"(mean size {results['mean_batch_size']:.1f}) "
        f"lowerings={info['lowerings']} kernel_launches={kernel_launches}",
        flush=True,
    )

    if args.save_logits:
        _save_logits(args.save_logits, xs, [h.result() for h in handles])
    _write_out(args, results)
    return results


if __name__ == "__main__":
    main()
