#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. Device and build: the card's name and power limit, then every CUDA
   kernel under ``src/repro_torch/kernels/csrc`` built with nvcc, one
   process per source, all at once.
2. Kernel vs plain: ``matmul_relu`` at every shape the serving path
   launches — the (1020, 784) and (1020, 1020) layers of the stack below
   at buckets 1, 8, 32 and 128, in f32 and bf16 — plus a ragged
   (1204, 3000) x (3000, 77), each held against its plain PyTorch
   version and timed beside it and beside ``relu(matmul)``.
3. The serving slice at full width: a Table-I MNIST-geometry stack
   (P=784, Q=10, n=2Q+1000=1020, L=20) with seeded untrained weights is
   exported with the port's ``export_artifact`` and served through
   ``repro_torch.launch.serve_dssfn.main``; the logits are held against
   a float64 numpy forward of the same weights.
4. The card line, one ``{"kernels": [...]}`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

It imports no JAX and nothing of the JAX package.  Without CUDA, or
without the repository's ``src/`` beside it, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# f32 on the CUDA cores, bf16 on the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# Tolerances, as a fraction of max|reference|.  f32: both versions sum
# K <= 3000 products in f32 in different orders, an error of order
# sqrt(K) * 2**-24 of the sum.  bf16: the f32 sums are rounded to bf16
# (8 significant bits), so a sum near a rounding boundary may round one
# ulp (2**-8 relative) either way.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# The full stack: 20 f32 layers of K ~ 1020 against float64 numpy; each
# layer adds an f32 rounding error of order sqrt(K) * 2**-24 ~ 2e-6.
STACK_TOL = 1e-4

SLICE = {"P": 784, "Q": 10, "L": 20}          # Table-I MNIST, paper §III-B
SLICE_BUCKETS = (1, 8, 32, 128)
SLICE_REQUESTS = 64
HEADLINE = ((1020, 1020), 32, "float32")       # the stream's batch shape


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def bound(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    """Least time (ms) for relu(W @ X): each operand read once and the
    output written once at HBM rate, or 2mnk operations at the peak rate
    of the operands' type, whichever is larger."""
    elem = 4 if dtype == "float32" else 2
    t_bytes = (m * k + k * n + m * n) * elem / PEAK_BYTES_PER_S
    t_ops = 2.0 * m * n * k / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, ws, x, iters: int = 60) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    timed with CUDA events around its replay, so the host's launch cost
    is left out.  The calls cycle through ``ws``, copies of W that
    together exceed the 50 MB L2, so each call finds its W in HBM, as a
    layer of the served stack does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for i in range(3):
            fn(ws[i % len(ws)], x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(ws[i % len(ws)], x)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(torch, np):
    from repro_torch.kernels.matmul_relu import matmul_relu_cuda, matmul_relu_ref

    p, q = SLICE["P"], SLICE["Q"]
    n = 2 * q + 1000
    shapes = [((n, p), b) for b in SLICE_BUCKETS] + [((n, n), b) for b in SLICE_BUCKETS]
    shapes.append(((1204, 3000), 77))
    rng = np.random.default_rng(1)
    cases = []
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for (m, k), cols in shapes:
            w = torch.from_numpy(
                (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
            ).to("cuda", dtype)
            x = torch.from_numpy(
                rng.standard_normal((k, cols)).astype(np.float32)
            ).to("cuda", dtype)
            out = matmul_relu_cuda(w, x)
            ref = matmul_relu_ref(w, x)
            torch.cuda.synchronize()
            if out.shape != ref.shape or out.dtype != ref.dtype:
                raise AssertionError(f"matmul_relu {m}x{k}x{cols}: {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = KERNEL_TOL[dtype_name] * scale
            if not err <= tol:
                raise AssertionError(
                    f"matmul_relu w({m},{k}) x({k},{cols}) {dtype_name}: "
                    f"max|kernel - plain| = {err:.3e} > {tol:.3e}"
                )
            copies = max(1, -(-100_000_000 // (w.numel() * w.element_size())))
            ws = [w.clone() for _ in range(copies)]
            kernel_ms = time_ms(torch, matmul_relu_cuda, ws, x)
            plain_ms = time_ms(torch, matmul_relu_ref, ws, x)
            library_ms = time_ms(torch, lambda a, b: torch.relu(torch.matmul(a, b)), ws, x)
            bound_ms, bound_by = bound(m, k, cols, dtype_name)
            del ws
            case = {
                "shape": f"w({m},{k}) x({k},{cols}) {dtype_name}",
                "key": ((m, k), cols, dtype_name),
                "max_abs_err": err,
                "tolerance": tol,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            print(
                f"matmul_relu {case['shape']}: err {err:.3e} (tol {tol:.3e}) "
                f"kernel {kernel_ms * 1e3:.2f} us plain {plain_ms * 1e3:.2f} us "
                f"library {library_ms * 1e3:.2f} us bound {bound_ms * 1e3:.2f} us "
                f"({bound_by})",
                flush=True,
            )
            cases.append(case)
    return cases


def random_stack(np, seed: int = 0):
    """Untrained Table-I stack: R_l and O_l ~ N(0, 1) / sqrt(fan_in), as
    ``repro``'s ``init_random_matrices`` scales R."""
    p, q, layers = SLICE["P"], SLICE["Q"], SLICE["L"]
    n = 2 * q + 1000
    rng = np.random.default_rng(seed)

    def draw(rows, fan_in):
        return (rng.standard_normal((rows, fan_in)) / np.sqrt(fan_in)).astype(np.float32)

    o_list = [draw(q, p)] + [draw(q, n) for _ in range(layers)]
    r_list = [draw(n - 2 * q, p if l == 0 else n) for l in range(layers)]
    return o_list, r_list


def forward_f64(np, o_list, r_list, x):
    y = x.astype(np.float64)
    for o, r in zip(o_list[:-1], r_list):
        w = np.concatenate([o, -o, r]).astype(np.float64)
        y = np.maximum(w @ y, 0.0)
    return o_list[-1].astype(np.float64) @ y


def forward_breakdown(torch, engine, bucket: int, reps: int = 20) -> dict:
    """Where one served forward's time goes at ``bucket``: the host clock
    around ``engine.forward`` + synchronize (what a batch waits), against
    the device time of the same forward replayed as a CUDA graph (its
    kernels alone).  The gap is the host's launch and Python cost."""
    x = torch.randn(engine.artifact.input_dim, bucket, device="cuda")
    engine.forward(x)
    torch.cuda.synchronize()
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.forward(x)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    device_ms = time_ms(torch, lambda _w, xx: engine.forward(xx), [None], x, iters=reps)
    return {"bucket": bucket, "host_ms_p50": host[len(host) // 2],
            "device_ms": device_ms}


def serve_slice(torch, np, card: str) -> int:
    """Serve the full-width stack; returns the main path's launch count."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import ssfn
    from repro_torch.kernels.matmul_relu import launch_count, reset_launch_count
    from repro_torch.launch import serve_dssfn
    from repro_torch.serve import ServeEngine, export_artifact, load_artifact

    o_list, r_list = random_stack(np)
    q, layers = SLICE["Q"], SLICE["L"]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "stack")
        export_artifact(path, params_from_numpy(o_list, r_list, device="cpu"))
        logits_path = os.path.join(tmp, "logits.npz")

        reset_launch_count()
        res = serve_dssfn.main([
            "--artifact", path, "--requests", str(SLICE_REQUESTS),
            "--request-size", "1",
            "--batch-bucket", ",".join(map(str, SLICE_BUCKETS)),
            "--max-batch", "32", "--max-wait-us", "200", "--seed", "0",
            "--save-logits", logits_path,
        ])
        main_path_launches = launch_count()

        if res["device"] != "cuda" or res["completed"] != SLICE_REQUESTS:
            raise AssertionError(f"served {res['completed']} of {SLICE_REQUESTS} on {res['device']}")
        if res["kernel_launches"] != layers * res["batches"]:
            raise AssertionError(
                f"kernel_launches {res['kernel_launches']} != {layers} x "
                f"{res['batches']} batches"
            )
        if main_path_launches == 0 or main_path_launches < res["kernel_launches"]:
            raise AssertionError(
                f"main path counted {main_path_launches} matmul_relu launches"
            )
        with np.load(logits_path) as z:
            x, logits = z["requests"], z["logits"]
        ref = forward_f64(np, o_list, r_list, x)
        err = float(np.abs(logits - ref).max())
        scale = float(np.abs(ref).max())
        if logits.shape != (q, SLICE_REQUESTS) or not np.isfinite(logits).all():
            raise AssertionError(f"logits shape {logits.shape} or non-finite")
        if not err <= STACK_TOL * scale:
            raise AssertionError(
                f"served logits vs float64: {err:.3e} > {STACK_TOL} x {scale:.3e}"
            )
        print(f"slice logits vs float64 numpy: max abs err {err:.3e} "
              f"(max|ref| {scale:.3e}, tol {STACK_TOL} x max|ref|)", flush=True)

        # Within one bucket the engine is the training-time predict, bit
        # for bit, and padding cannot perturb the real columns.
        engine = ServeEngine(load_artifact(path), buckets=(32,))
        xb = torch.from_numpy(x[:, :32].copy())
        out = engine.forward(xb)
        pred = ssfn.predict(
            params_from_numpy(o_list, r_list, device="cuda"), xb.cuda(), q
        )
        padded = engine.forward(xb[:, :5])
        torch.cuda.synchronize()
        if not torch.equal(out, pred):
            raise AssertionError("ServeEngine.forward != ssfn.predict within bucket 32")
        if not torch.equal(padded, out[:, :5]):
            raise AssertionError("padded forward differs from the full bucket")
        print("ServeEngine.forward == ssfn.predict bit for bit (bucket 32, "
              "padded and full)", flush=True)

        engine = ServeEngine(load_artifact(path), buckets=(1, 128))
        for bucket in (1, 128):
            fb = forward_breakdown(torch, engine, bucket)
            print(
                f"forward bucket {bucket}: host {fb['host_ms_p50']:.3f} ms "
                f"(p50, synchronized), device {fb['device_ms']:.3f} ms "
                f"(CUDA graph replay), {layers} kernel launches",
                flush=True,
            )

    lat = res["latency_ms"]
    print(
        f"slice P={SLICE['P']} Q={q} n={2 * q + 1000} L={layers}: "
        f"{SLICE_REQUESTS} requests in {res['batches']} batches, "
        f"p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms, "
        f"{res['throughput_samples_per_s']:.0f} samples/s, "
        f"kernel_launches {res['kernel_launches']} on {card}",
        flush=True,
    )
    return main_path_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    cases = kernel_cases(torch, np)
    launches = serve_slice(torch, np, card)

    head = next(c for c in cases if c["key"] == HEADLINE)
    kernels = [{
        "name": "matmul_relu",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul_relu.cu",
        "replaces": "src/repro/kernels/matmul_relu/kernel.py:36",
        "launches": launches,
        "shapes": head["shape"],
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": [{k: v for k, v in c.items() if k != "key"} for c in cases],
    }]
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
