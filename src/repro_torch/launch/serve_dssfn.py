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
        "and 'logits' (Q, N), columns in request order",
    )
    return ap.parse_args(argv)


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(p / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


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
        os.makedirs(os.path.dirname(args.save_logits) or ".", exist_ok=True)
        logits = torch.cat([h.result() for h in handles], dim=1)
        np.savez(
            args.save_logits,
            requests=torch.cat(xs, dim=1).numpy(),
            logits=logits.float().cpu().numpy(),
        )
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
