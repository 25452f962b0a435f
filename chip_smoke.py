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
3. Kernel vs plain: ``gram`` and ``propagate_gram`` at every shape the
   training slice launches — layer 0 (20, 784, 3000) and (1, 784, 60000),
   layers 1 and l >= 2 with W (1020, 784) and (1020, 1020) over M=20
   workers of 3000 samples and one of 60000 — plus ragged cases in f32
   and bf16, each timed beside its plain version, its library call
   (``baddbmm``; ``relu(matmul)`` then ``baddbmm``) and two bounds, at the
   f32 CUDA-core peak and at the tensor-core peak the kernels compute at
   (three TF32 products per f32 product; bf16 at the bf16 peak), with its
   TFLOP/s; the headline and centralized ``gram`` also held within 8 f32
   ulps of max|G| of a float64 Gram.
4. The serving slice at full width: a Table-I MNIST-geometry stack
   (P=784, Q=10, n=2Q+1000=1020, L=20) with seeded untrained weights is
   exported with the port's ``export_artifact`` and served through
   ``repro_torch.launch.serve_dssfn.main``; the logits are held against
   a float64 numpy forward of the same weights.
5. The training slice at full width: Table-I MNIST geometry (P=784,
   Q=10, n=1020, L=20, K=100, J=60000 train and 10000 test of the port's
   planted-teacher data) trained through
   ``repro_torch.launch.train_dssfn.main``, decentralized (M=20) and
   centralized (M=1).  It checks finite readouts, one ``gram`` and 20
   ``propagate_gram`` launches per train, a full-width layer-1 step on
   the card against the same step on the CPU through the plain versions,
   the reference's centralized-equivalence bars, and that the exported
   stack serves through ``ServeEngine`` bit for bit like
   ``ssfn.predict``.  It prints where a layer's time goes.
6. Kernel vs plain: ``flash_attention`` at the full-width H2O-Danube3-4B
   shapes — (1, 32, 8192, 120) and (1, 32, 4096, 120) with the 4096
   window, in bf16 and f32, and (1, 32, 8192, 120) over KV at 8 heads, as
   the model launches it (GQA read in place) — plus a ragged
   (1, 32, 4100, 120), a (2, 8, 77, 80) and Zamba2-2.7B's (1, 32, 8192,
   80), each held per element against its plain version (bf16 also
   launched twice, bit for bit) and timed beside it, beside
   ``scaled_dot_product_attention`` and beside its bound, with its
   TFLOP/s and its share of the bound.
7. The inference slice at full width: H2O-Danube3-4B, all 24 layers, with
   seeded weights and tokens from the port's ``TokenStream``.  (a) A bf16
   scoring forward through ``make_loss_fn`` at B=1, S=8192 with the
   kernel on: 24 launches and a finite loss, and where the forward's time
   goes (CUDA events around the whole forward and around each kernel call
   in it).  (b) The same forward in f32, kernel route against the plain
   chunked route.  (c) ``repro_torch.launch.serve.serve`` at batch 2, a
   4608-token prompt (past the window, so the ring cache wraps) and 16
   generated tokens, in bf16.  (d) In f32, prefill + greedy decode
   logits at each generated position against the f32 forward's, and
   where a decode step's time goes (the host's enqueue against the
   synchronized step).
8. Kernel vs plain: ``ssm_scan`` at the full-width Zamba2-2.7B Mamba2
   shapes — (1, 8192, 32, 160), state 64, chunk 256, in bf16 and f32, at
   B=2, and at S=4352 (4100 padded to whole chunks) — plus chunk 64 and
   chunk 16 at the reduced width and an odd dh of 80, each held per element
   against its plain version (and launched twice, bit for bit), timed
   beside it and beside its bound.
9. The hybrid slice at full width: Zamba2-2.7B, all 54 Mamba2 layers and
   9 calls of its shared attention block, seeded weights.  (a) A bf16
   scoring forward at B=1, S=8192 with the kernels on: 54 ``ssm_scan``
   and 9 ``flash_attention`` launches, a finite loss, and each kernel's
   share of the forward.  (b) In f32, every Mamba2 layer's kernel call
   against the plain scan on the same input, and the kernel route's
   logits against the plain route's, beside the model's response to one
   ulp of noise.  (c) ``launch.serve.serve`` at batch 2, a 4608-token
   prompt and 16 generated tokens, in bf16.  (d) In f32, prefill + greedy
   decode logits against the forward's.
10. Kernel vs plain: ``mlstm_scan`` at the full-width xLSTM-350M mLSTM
    shapes — (1, 8192, 4, 256), chunk 256, in bf16 and f32, at B=2 and
    S=4608, and at S=4352 (4100 padded with the model's padding) — plus
    the reduced (2, 128, 4, 64) at chunk 16 and dk 64 != dv 128 at chunk
    64, each held per element against its plain version (y and the final
    C, n, m; launched twice, bit for bit), timed beside it and beside its
    bound.
11. The xLSTM slice at full width: xLSTM-350M, all 24 layers (20 mLSTM, 4
    sLSTM), seeded weights.  (a) A bf16 scoring forward at B=1, S=8192
    with the kernel on: 20 ``mlstm_scan`` launches, a finite loss, and
    the kernel's and the sLSTM layers' shares of the forward.  (b) In
    f32, every mLSTM layer's kernel call against the plain scan on the
    same input, and the kernel route's logits against the plain route's,
    beside the model's response to one ulp of noise.  (c)
    ``launch.serve.serve`` at batch 2, a 4608-token prompt and 16
    generated tokens, in bf16.  (d) In f32, prefill + greedy decode logits
    against the forward's, and a decode step's host enqueue against the
    synchronized step.
12. The card line, one ``{"kernels": [...]}`` line, and as the last line
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
# TF32 on the tensor cores, the rate the Gram kernels compute f32 at:
# three TF32 products per f32 product (3xTF32).
PEAK_TF32 = 495e12

# Tolerances, as a fraction of max|reference|.  f32: both versions sum
# K <= 3000 products in f32 in different orders, an error of order
# sqrt(K) * 2**-24 of the sum.  bf16: the f32 sums are rounded to bf16
# (8 significant bits), so a sum near a rounding boundary may round one
# ulp (2**-8 relative) either way.
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# The full stack: 20 f32 layers of K ~ 1020 against float64 numpy; each
# layer adds an f32 rounding error of order sqrt(K) * 2**-24 ~ 2e-6.
STACK_TOL = 1e-4

# Gram kernels: f32 sums of J products in two orders.  An f32 sum of J
# terms taken in order is off by about sqrt(J) 2**-24 of its size (a
# random walk of roundings), and the library GEMM behind the plain
# version may sum in order.  So the tolerance is 1e-5 x max|plain| up to
# J = 7000 (2 sqrt(7000) 2**-24 = 1.0e-5) and 2 sqrt(J) 2**-24 x
# max|plain| above: 2.9e-5 at J = 60000, the centralized layer.
def gram_tol(j: int) -> float:
    return max(1e-5, 2.0 * j**0.5 * 2.0**-24)


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


def roofline(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """Least time (ms): ``nbytes`` at HBM rate or ``ops`` at the peak rate
    of the operands' type, whichever is larger, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def elem_bytes(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def bound(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    """relu(W @ X): each operand read once, the output written once, 2mnk
    operations."""
    return roofline(2.0 * m * n * k, (m * k + k * n + m * n) * elem_bytes(dtype), dtype)


def gram_ops(m: int, n: int, j: int) -> float:
    """A symmetric Gram: n(n+1)J operations per worker."""
    return float(n) * (n + 1) * j * m


def gram_bytes(m: int, n: int, j: int, dtype: str) -> float:
    """Y read once, the f32 G written once."""
    return m * n * j * elem_bytes(dtype) + m * n * n * 4


def propagate_ops(n: int, n_prev: int, m: int, j: int) -> tuple[float, float]:
    """(propagation, Gram) operations of propagate_gram: 2 n n_prev J M and
    n(n+1) J M."""
    return 2.0 * n * n_prev * j * m, gram_ops(m, n, j)


def propagate_bytes(n: int, n_prev: int, m: int, j: int, dtype: str) -> float:
    """W and Y read once, Y' and the f32 G written once."""
    return (n * n_prev + m * n_prev * j + m * n * j) * elem_bytes(dtype) + m * n * n * 4


def gram_bound(m: int, n: int, j: int, dtype: str) -> tuple[float, str]:
    """G = Y Y^T + I/mu for M workers at the f32 CUDA-core peak."""
    return roofline(gram_ops(m, n, j), gram_bytes(m, n, j, dtype), dtype)


def propagate_bound(n: int, n_prev: int, m: int, j: int, dtype: str) -> tuple[float, str]:
    """Y' = relu(W @ Y_m), G = Y' Y'^T + I/mu at the f32 CUDA-core peak."""
    return roofline(sum(propagate_ops(n, n_prev, m, j)), propagate_bytes(n, n_prev, m, j, dtype),
                    dtype)


def tensor_core_s(ops: float, dtype: str) -> float:
    """Seconds for ``ops`` operations on ``dtype`` operands on the tensor
    cores: f32 as three TF32 products each (3xTF32) at the TF32 peak,
    bf16 at the bf16 peak."""
    return 3 * ops / PEAK_TF32 if dtype == "float32" else ops / PEAK_FLOPS[dtype]


def tensor_core_bound(t_ops: float, nbytes: float) -> tuple[float, str]:
    """Least time (ms): ``t_ops`` seconds of tensor-core work or ``nbytes``
    at HBM rate, whichever is larger, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gram_tensor_core_bound(m: int, n: int, j: int, dtype: str) -> tuple[float, str]:
    """gram_bound's work on the tensor cores (3xTF32 for f32)."""
    return tensor_core_bound(tensor_core_s(gram_ops(m, n, j), dtype), gram_bytes(m, n, j, dtype))


def propagate_tensor_core_bound(n: int, n_prev: int, m: int, j: int,
                                dtype: str) -> tuple[float, str]:
    """propagate_bound's work on the tensor cores: the propagation in
    ``dtype``, the Gram of the f32 Y' in 3xTF32."""
    prop, gram = propagate_ops(n, n_prev, m, j)
    return tensor_core_bound(tensor_core_s(prop, dtype) + tensor_core_s(gram, "float32"),
                             propagate_bytes(n, n_prev, m, j, dtype))


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


# (M, n, J, dtype) of the gram launches: the train's layer 0, decentralized
# (M=20 workers of 3000) and centralized (one of 60000), and ragged edges.
GRAM_CASES = [(20, 784, 3000, "float32"), (1, 784, 60000, "float32"),
              (3, 33, 65, "float32"), (3, 33, 65, "bfloat16")]
# (n, n_prev, M, J, dtype) of the propagate_gram launches: layer 1 (W is
# 1020 x 784) and layers l >= 2 (1020 x 1020), decentralized and
# centralized, and ragged edges.
PROPAGATE_CASES = [(1020, 784, 20, 3000, "float32"), (1020, 1020, 20, 3000, "float32"),
                   (1020, 784, 1, 60000, "float32"), (1020, 1020, 1, 60000, "float32"),
                   (33, 257, 3, 65, "float32"), (33, 257, 3, 65, "bfloat16")]
GRAM_HEADLINE = (20, 784, 3000, "float32")
# gram cases also held against a float64 Gram, within GRAM_F64_ULPS f32
# ulps of max|G| (the bar of test_gram_sums_are_compensated; a 1xTF32 Gram
# misses it): the headline and the centralized layer.
GRAM_F64_CASES = [(20, 784, 3000, "float32"), (1, 784, 60000, "float32")]
GRAM_F64_ULPS = 8
PROPAGATE_HEADLINE = (1020, 1020, 20, 3000, "float32")
GRAM_MU = 1e-3      # SSFNConfig.mu0, the layer-0 mu
PROPAGATE_MU = 1.0  # SSFNConfig.mul


def max_err(got, want) -> tuple[float, float]:
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


def gram_kernel_cases(torch):
    """gram and propagate_gram at the training slice's shapes, each held
    against its plain version and timed beside it, beside one library
    call of the same function and beside two bounds: at the f32 CUDA-core
    peak (``f32_bound_ms``, as before the kernels took the tensor cores)
    and at the TF32 rate they compute at (``bound_ms``).  The headline and
    centralized ``gram`` are also held against a float64 Gram (``ulps``,
    in f32 ulps of max|G|)."""
    from repro_torch.kernels.gram import gram_cuda, gram_ref
    from repro_torch.kernels.propagate_gram import propagate_gram_cuda, propagate_gram_ref

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(2)

    def normal(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtypes[dtype])

    def diag(n, mu, dtype):
        return (torch.eye(n, device="cuda") / mu).to(dtype)

    gram_cases, prop_cases = [], []
    for m, n, j, dt in GRAM_CASES:
        y = normal((m, n, j), 1.0, dt)
        got, want = gram_cuda(y, mu=GRAM_MU), gram_ref(y, mu=GRAM_MU)
        torch.cuda.synchronize()
        err, scale = max_err(got, want)
        tol = gram_tol(j) * scale
        if got.shape != (m, n, n) or not err <= tol or not torch.equal(got, got.mT):
            raise AssertionError(
                f"gram y({m},{n},{j}) {dt}: max|kernel - plain| = {err:.3e} > "
                f"{tol:.3e}, or G not exactly symmetric"
            )
        ulps = None
        if (m, n, j, dt) in GRAM_F64_CASES:
            y64 = y.double()
            want64 = y64 @ y64.mT + torch.eye(n, dtype=torch.float64, device="cuda") / GRAM_MU
            ulps = ((got.double() - want64).abs().max()
                    / (2.0**-24 * want64.abs().max())).item()
            del y64, want64
            if not ulps <= GRAM_F64_ULPS:
                raise AssertionError(
                    f"gram y({m},{n},{j}) {dt}: {ulps:.2f} f32 ulps of max|G| from a "
                    f"float64 Gram > {GRAM_F64_ULPS}"
                )
        d = diag(n, GRAM_MU, y.dtype)
        iters = 10 if m * n * j > 1e7 else 60
        ms = time_ms(torch, lambda _w, a: gram_cuda(a, mu=GRAM_MU), [None], y, iters)
        plain_ms = time_ms(torch, lambda _w, a: gram_ref(a, mu=GRAM_MU), [None], y, iters)
        library_ms = time_ms(torch, lambda _w, a: torch.baddbmm(d, a, a.mT), [None], y, iters)
        f32_bound_ms, _ = gram_bound(m, n, j, dt)
        bound_ms, bound_by = gram_tensor_core_bound(m, n, j, dt)
        gram_cases.append({
            "shape": f"y({m},{n},{j}) {dt}", "key": (m, n, j, dt),
            "max_abs_err": err, "tolerance": tol, "ulps": ulps, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "tflops": gram_ops(m, n, j) / ms / 1e9, "bound_ms": bound_ms,
            "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
        })
        del y, got, want
    for n, n_prev, m, j, dt in PROPAGATE_CASES:
        w = normal((n, n_prev), n_prev**-0.5, dt)
        y = torch.relu(normal((m, n_prev, j), 1.0, dt))
        (y_new, g), (want_y, want_g) = (
            propagate_gram_cuda(w, y, mu=PROPAGATE_MU),
            propagate_gram_ref(w, y, mu=PROPAGATE_MU),
        )
        torch.cuda.synchronize()
        err_y, scale_y = max_err(y_new, want_y)
        err_g, scale_g = max_err(g, want_g)
        tol_y = KERNEL_TOL[dt] * scale_y
        tol_g = gram_tol(j) * scale_g   # G is built from the f32 Y' in both
        if not (err_y <= tol_y and err_g <= tol_g and torch.equal(g, g.mT)):
            raise AssertionError(
                f"propagate_gram w({n},{n_prev}) y({m},{n_prev},{j}) {dt}: "
                f"Y' err {err_y:.3e} (tol {tol_y:.3e}), G err {err_g:.3e} "
                f"(tol {tol_g:.3e}), or G not exactly symmetric"
            )
        d = diag(n, PROPAGATE_MU, y.dtype)

        def library(ww, yy, d=d):
            yn = torch.relu(torch.matmul(ww, yy))
            return torch.baddbmm(d, yn, yn.mT)

        iters = 10 if m * n * j > 1e7 else 60
        ms = time_ms(torch, lambda ww, yy: propagate_gram_cuda(ww, yy, mu=PROPAGATE_MU), [w], y, iters)
        plain_ms = time_ms(torch, lambda ww, yy: propagate_gram_ref(ww, yy, mu=PROPAGATE_MU), [w], y, iters)
        library_ms = time_ms(torch, library, [w], y, iters)
        f32_bound_ms, _ = propagate_bound(n, n_prev, m, j, dt)
        bound_ms, bound_by = propagate_tensor_core_bound(n, n_prev, m, j, dt)
        prop_cases.append({
            "shape": f"w({n},{n_prev}) y({m},{n_prev},{j}) {dt}", "key": (n, n_prev, m, j, dt),
            "max_abs_err": max(err_y, err_g), "max_abs_err_y": err_y, "max_abs_err_g": err_g,
            "tolerance": tol_g, "ulps": None, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "tflops": sum(propagate_ops(n, n_prev, m, j)) / ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
        })
        del w, y, y_new, g, want_y, want_g
    for name, cases in (("gram", gram_cases), ("propagate_gram", prop_cases)):
        for c in cases:
            ulps = "" if c["ulps"] is None else f", {c['ulps']:.2f} ulps of max|G| from float64"
            print(
                f"{name} {c['shape']}: err {c['max_abs_err']:.3e} (tol {c['tolerance']:.3e}"
                f"{ulps}) kernel {c['ms']:.3f} ms = {c['tflops']:.1f} TFLOP/s, plain "
                f"{c['plain_ms']:.3f} ms, library {c['library_ms']:.3f} ms, bound "
                f"{c['f32_bound_ms']:.3f} ms at the f32 CUDA-core peak, {c['bound_ms']:.3f} ms "
                f"at the tensor-core peak ({c['bound_by']})",
                flush=True,
            )
    return gram_cases, prop_cases


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


# Table-I MNIST geometry (paper §III-B; repro's benchmarks/common.py):
# P=784, Q=10, n=2Q+1000, L=20 layers, K=100 ADMM iterations, M=20
# workers, 60000 training and 10000 test samples of the port's synthetic
# planted-teacher data, SSFNConfig's mu0=1e-3 and mul=1.
TRAIN = {"P": 784, "Q": 10, "n": 1020, "L": 20, "K": 100, "M": 20,
         "J": 60000, "J_test": 10000, "seed": 0}
# Reference bars for centralized equivalence (tests/test_system.py:45-49).
EQUIV_AGREEMENT = 0.85
EQUIV_ACC_GAP = 0.05
STEP_TOL = 1e-4   # o_star, card vs CPU: relative Frobenius gap


def train_argv(workers: int, artifact: str) -> list[str]:
    t = TRAIN
    return [
        "--workers", str(workers), "--layers", str(t["L"]), "--hidden", str(t["n"]),
        "--classes", str(t["Q"]), "--input-dim", str(t["P"]), "--train", str(t["J"]),
        "--test", str(t["J_test"]), "--admm-iters", str(t["K"]),
        "--seed", str(t["seed"]), "--export-artifact", artifact,
    ]


def card_params(torch, path: str):
    """The readouts and R of an exported artifact, as tensors on the card."""
    from repro_torch.core.ssfn import SSFNParams
    from repro_torch.serve import load_artifact

    p = load_artifact(path).params
    return SSFNParams(o=tuple(o.cuda() for o in p.o), r=tuple(r.cuda() for r in p.r))


def timed(torch, fn):
    """(result, ms): fn's span on the card's timeline, host gaps included."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def layer_breakdown(torch, x_workers, t_workers, w1, cfg) -> dict:
    """Where a full-width layer step's time goes on the card (layer 1,
    M workers, the train's own settings), then the same step on the CPU
    through the plain versions from the same inputs, held against it."""
    from repro_torch.core import admm, engine
    from repro_torch.core.backend import SimulatedBackend
    from repro_torch.kernels.propagate_gram import propagate_gram, propagate_gram_ref

    m = x_workers.shape[0]
    x = x_workers.contiguous()
    kw = dict(mu=cfg.mul, eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters)
    step0, ms_step0 = timed(torch, lambda: engine.fused_layer_step(
        SimulatedBackend(m), x, t_workers, None, mu=cfg.mu0,
        eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters))
    step1, ms_step1 = timed(torch, lambda: engine.fused_layer_step(
        SimulatedBackend(m), x, t_workers, w1, **kw))
    (y1, g), ms_kernel = timed(torch, lambda: propagate_gram(w1, x, mu=cfg.mul))
    (chol, _), ms_chol = timed(torch, lambda: admm.guarded_cholesky(g))
    a, ms_a = timed(torch, lambda: torch.matmul(t_workers, y1.mT))
    z0 = torch.zeros_like(a[0])
    _, ms_admm = timed(torch, lambda: admm.worker_admm_iterations(
        SimulatedBackend(m), a, chol, y1, t_workers, z0, trace_every=1, **kw))
    _, ms_admm0 = timed(torch, lambda: admm.worker_admm_iterations(
        SimulatedBackend(m), a, chol, y1, t_workers, z0, trace_every=0, **kw))

    # The same step on the CPU, through the plain versions.
    x_c, t_c, w_c = x.cpu(), t_workers.cpu(), w1.cpu()
    y_ref, g_ref = propagate_gram_ref(w_c, x_c, mu=cfg.mul)
    err_y, scale_y = max_err(y1.cpu(), y_ref)
    err_g, scale_g = max_err(g.cpu(), g_ref)
    j = x.shape[2]
    if not (err_y <= KERNEL_TOL["float32"] * scale_y and err_g <= gram_tol(j) * scale_g):
        raise AssertionError(
            f"layer-1 step: card vs CPU Y' err {err_y:.3e} (max {scale_y:.3e}), "
            f"G err {err_g:.3e} (max {scale_g:.3e})"
        )
    del y_ref, g_ref
    cpu_step = engine.fused_layer_step(
        SimulatedBackend(m), x_c, t_c, w_c, trace_every=0, **kw)
    # Both f32 steps beside a float64 step of the same math on the CPU,
    # so a gap between them can be told apart from f32 rounding.
    f64 = torch.float64
    y64 = torch.relu(w_c.to(f64) @ x_c.to(f64))
    g64 = y64 @ y64.mT + torch.eye(y64.shape[1], dtype=f64) / cfg.mul
    t64 = t_c.to(f64)
    (_, z64, _), _ = admm.worker_admm_iterations(
        SimulatedBackend(m), t64 @ y64.mT, torch.linalg.cholesky(g64), y64, t64,
        torch.zeros_like(z0, device="cpu", dtype=f64), trace_every=0, **kw)
    del y64, g64

    def rel(a, b):
        a, b = a.detach().cpu().to(f64), b.detach().cpu().to(f64)
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    gap = rel(step1.o_star, cpu_step.o_star)
    if not gap <= STEP_TOL:
        raise AssertionError(f"layer-1 o_star card vs CPU: relative gap {gap:.3e} > {STEP_TOL}")
    return {
        "layer0_ms": ms_step0, "layer1_ms": ms_step1, "propagate_gram_ms": ms_kernel,
        "cholesky_ms": ms_chol, "a_ms": ms_a, "admm_ms": ms_admm,
        "admm_untraced_ms": ms_admm0, "err_y": err_y, "err_g": err_g,
        "o_star_gap": gap, "card_f64_gap": rel(step1.o_star, z64[0]),
        "cpu_f64_gap": rel(cpu_step.o_star, z64[0]), "jitter": step1.jitter.tolist(),
    }


def train_slice(torch, card: str) -> dict:
    """Train the full-width stack decentralized and centralized through the
    launcher, check it, break a layer's time down, serve what it trained.
    Returns each training kernel's main-path launch count."""
    from repro_torch.core import equivalence, ssfn
    from repro_torch.data import make_classification, partition_workers
    from repro_torch.kernels import gram, matmul_relu, propagate_gram
    from repro_torch.launch import train_dssfn
    from repro_torch.serve import ServeEngine, load_artifact

    counters = (gram, propagate_gram, matmul_relu)
    launches = {"gram": 0, "propagate_gram": 0}
    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        for label, workers in (("decentralized", TRAIN["M"]), ("centralized", 1)):
            path = os.path.join(tmp, label)
            for c in counters:
                c.reset_launch_count()
            res = train_dssfn.main(train_argv(workers, path))
            counts = {"gram": gram.launch_count(), "propagate_gram": propagate_gram.launch_count()}
            run = res["runs"][0]
            if res["device"] != "cuda" or run["kernel_launches"]["gram"] != 1 \
                    or run["kernel_launches"]["propagate_gram"] != TRAIN["L"] \
                    or counts != {"gram": 1, "propagate_gram": TRAIN["L"]}:
                raise AssertionError(
                    f"{label} train on {res['device']}: kernel launches "
                    f"{run['kernel_launches']} (counters {counts}); expected 1 "
                    f"gram and {TRAIN['L']} propagate_gram"
                )
            for k in launches:
                launches[k] += counts[k]
            params = card_params(torch, path)
            if not all(bool(torch.isfinite(o).all()) for o in params.o):
                raise AssertionError(f"{label} train: non-finite readouts")
            if run["final_objective"] is None or run["final_objective"] != run["final_objective"]:
                raise AssertionError(f"{label} train: objective {run['final_objective']}")
            runs[label] = (run, params, path)
            print(
                f"train {label} M={workers}: {run['wall_time_s']:.3f} s per train, "
                f"{run['wall_time_s'] / (TRAIN['L'] + 1) * 1e3:.1f} ms per layer (mean), "
                f"objective {run['final_objective']:.4f}, test accuracy "
                f"{run['test_accuracy']:.4f}, jitter events {run['jitter_events']}, "
                f"kernel launches {run['kernel_launches']} on {card}",
                flush=True,
            )

        # The launcher's data and R, made again from the same seeds.
        q = TRAIN["Q"]
        data = make_classification(
            torch.Generator(device="cuda").manual_seed(TRAIN["seed"]),
            num_train=TRAIN["J"], num_test=TRAIN["J_test"],
            input_dim=TRAIN["P"], num_classes=q,
        )
        (run_d, dec, dec_path), (run_c, cen, _) = runs["decentralized"], runs["centralized"]
        rep = equivalence.compare(cen, dec, data.x_test, q)
        acc_gap = abs(run_d["test_accuracy"] - run_c["test_accuracy"])
        print(
            f"equivalence centralized vs decentralized (M={TRAIN['M']}, K={TRAIN['K']}): "
            f"max readout gap {rep.max_readout_gap:.3e}, prediction gap "
            f"{rep.prediction_gap:.3e}, agreement {rep.agreement:.4f}, "
            f"|test accuracy gap| {acc_gap:.4f}",
            flush=True,
        )
        if not (rep.agreement >= EQUIV_AGREEMENT and acc_gap < EQUIV_ACC_GAP):
            raise AssertionError(
                f"equivalence bars missed: agreement {rep.agreement:.4f} "
                f"(>= {EQUIV_AGREEMENT}), accuracy gap {acc_gap:.4f} (< {EQUIV_ACC_GAP})"
            )

        cfg = ssfn.SSFNConfig(input_dim=TRAIN["P"], num_classes=q, num_layers=TRAIN["L"],
                              hidden=TRAIN["n"], admm_iters=TRAIN["K"])
        xw, tw = partition_workers(data.x_train, data.t_train, TRAIN["M"])
        w1 = ssfn.build_weight(dec.o[0], dec.r[0], q)
        bd = layer_breakdown(torch, xw, tw, w1, cfg)
        share = bd["propagate_gram_ms"] / bd["layer1_ms"]
        print(
            f"layer step on the card (M={TRAIN['M']}, J_m={TRAIN['J'] // TRAIN['M']}): "
            f"layer 0 {bd['layer0_ms']:.2f} ms, layer 1 {bd['layer1_ms']:.2f} ms = "
            f"propagate_gram {bd['propagate_gram_ms']:.2f} ms ({share:.0%}) + "
            f"guarded Cholesky {bd['cholesky_ms']:.2f} ms + A=TY^T {bd['a_ms']:.2f} ms + "
            f"{TRAIN['K']} ADMM iterations {bd['admm_ms']:.2f} ms traced "
            f"({bd['admm_untraced_ms']:.2f} ms untraced); vs CPU plain: Y' err "
            f"{bd['err_y']:.3e}, G err {bd['err_g']:.3e}, o_star gap "
            f"{bd['o_star_gap']:.3e} (card vs float64 {bd['card_f64_gap']:.3e}, "
            f"CPU f32 vs float64 {bd['cpu_f64_gap']:.3e}), jitter {bd['jitter']}",
            flush=True,
        )

        # The trained stack serves: within one bucket, bit for bit predict.
        engine = ServeEngine(load_artifact(dec_path), buckets=(32,))
        xb = data.x_test[:, :32].contiguous()
        out = engine.forward(xb.cpu())
        pred = ssfn.predict(dec, xb, q)
        torch.cuda.synchronize()
        if not torch.equal(out, pred):
            raise AssertionError("trained stack: ServeEngine.forward != ssfn.predict (bucket 32)")
        print("trained stack served: ServeEngine.forward == ssfn.predict bit for bit "
              "(bucket 32)", flush=True)
    return launches


# flash_attention at the full-width H2O-Danube3-4B attention (32 heads of
# 120 over 8 KV heads, window 4096; also with KV at 32 heads, the earlier
# slices' headline) and Zamba2-2.7B's shared attention (32 heads of 80):
# (B, H, H_kv, S, hd, window, dtype).
FLASH_CASES = [(1, 32, 32, 8192, 120, 4096, "bfloat16"),
               (1, 32, 8, 8192, 120, 4096, "bfloat16"),   # what the model launches
               (1, 32, 32, 4096, 120, 4096, "bfloat16"),
               (1, 32, 32, 8192, 120, 4096, "float32"), (1, 32, 32, 4096, 120, 4096, "float32"),
               (1, 32, 32, 4100, 120, 4096, "bfloat16"), (2, 8, 8, 77, 80, None, "float32"),
               (1, 32, 32, 8192, 80, 4096, "bfloat16")]   # Zamba2-2.7B's shared attention
FLASH_HEADLINE = (1, 32, 32, 8192, 120, 4096, "bfloat16")
# flash_attention tolerance, per element: |kernel - plain| <= rel |plain|
# + 1e-5 max|plain|.  The second term is f32's (KERNEL_TOL: sums in other
# orders).  bf16 adds rel = 2**-7: both versions round one f32 result to
# bf16, so an element whose f32 values straddle a rounding boundary may
# differ by one bf16 ulp, at most 2**-7 of its size.  Held per element,
# not against max|plain|: past the first rows an output averages over
# thousands of keys and is some 100x smaller than max|plain|, so a global
# bf16 limit would pass a dropped or mis-weighted KV tile there.
FLASH_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def flash_excess(got, want, dtype: str) -> tuple[float, float, float]:
    """(max|got - want|, its floor 1e-5 max|want|, max over elements of
    |got - want| - allowed): the last is <= 0 when every element passes."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    floor = KERNEL_TOL["float32"] * want.abs().max().item()
    excess = (diff - FLASH_REL[dtype] * want.abs()).max().item() - floor
    return diff.max().item(), floor, excess


def attended_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal (sliding-window) attention computes:
    query q sees min(q + 1, window) keys."""
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_ops(b: int, h: int, s: int, hd: int, window) -> float:
    """4 hd operations per attended pair: 2 hd for q.k, 2 hd for p v."""
    return 4.0 * hd * b * h * attended_pairs(s, window)


def flash_bound(b: int, h: int, h_kv: int, s: int, hd: int, window,
                dtype: str) -> tuple[float, str]:
    """q and the H_kv heads of k and v read once, the output written once;
    :func:`flash_ops` at the peak rate of the inputs' type (bf16: tensor
    cores)."""
    return roofline(flash_ops(b, h, s, hd, window),
                    2 * b * (h + h_kv) * s * hd * elem_bytes(dtype), dtype)


def time_calls(torch, fn, iters: int) -> float:
    """Device ms per call: CUDA events around ``iters`` back-to-back calls
    after one warm-up call.  For calls of a millisecond or more the host's
    launch cost hides behind the queued work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_kernel_cases(torch):
    """flash_attention at the inference slice's shapes, each held against
    its plain version, launched twice for bit-identity (bf16), and timed
    beside its plain version, beside one library call
    (``scaled_dot_product_attention``, with ``enable_gqa`` where KV has
    fewer heads) and beside its bound."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for b, h, h_kv, s, hd, window, dt in FLASH_CASES:
        shape = f"({b},{h},{s},{hd}) KV heads {h_kv} window {window} {dt}"
        q = torch.randn((b, h, s, hd), generator=gen, device="cuda").to(dtypes[dt])
        k, v = (torch.randn((b, h_kv, s, hd), generator=gen, device="cuda").to(dtypes[dt])
                for _ in range(2))
        got = flash_attention_cuda(q, k, v, window=window)
        want = flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        err, floor, excess = flash_excess(got, want, dt)
        tol = f"{FLASH_REL[dt]:.3e} |plain| + {floor:.3e}"
        if got.shape != q.shape or got.dtype != q.dtype or not excess <= 0.0:
            raise AssertionError(
                f"flash_attention {shape}: an element exceeds |kernel - plain| <= {tol} by "
                f"{excess:.3e}"
            )
        if dt == "bfloat16" and not torch.equal(got, flash_attention_cuda(q, k, v,
                                                                          window=window)):
            raise AssertionError(f"flash_attention {shape}: two launches differ")
        del got, want
        gqa = {"enable_gqa": True} if h_kv != h else {}
        if window is None or window >= s:   # the window masks nothing
            def library(q=q, k=k, v=v, gqa=gqa):
                return sdpa(q, k, v, is_causal=True, **gqa)
        else:
            pos = torch.arange(s, device="cuda")
            allowed = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)

            def library(q=q, k=k, v=v, allowed=allowed, gqa=gqa):
                return sdpa(q, k, v, attn_mask=allowed, **gqa)
        big = s >= 4096
        ms = time_calls(torch, lambda: flash_attention_cuda(q, k, v, window=window),
                        5 if big else 50)
        plain_ms = time_calls(torch, lambda: flash_attention_ref(q, k, v, window=window),
                              2 if big else 50)
        library_ms = time_calls(torch, library, 5 if big else 50)
        bound_ms, bound_by = flash_bound(b, h, h_kv, s, hd, window, dt)
        f32_ms, _ = flash_bound(b, h, h_kv, s, hd, window, "float32")
        tflops = flash_ops(b, h, s, hd, window) / ms / 1e9
        cases.append({
            "shape": shape, "key": (b, h, h_kv, s, hd, window, dt), "max_abs_err": err,
            "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
            "tflops": tflops, "f32_simt_bound_ms": f32_ms,
            "attended_pairs_per_head": attended_pairs(s, window),
        })
        print(
            f"flash_attention {shape}: err {err:.3e} (tol {tol} per element"
            f"{', bit-identical on two launches' if dt == 'bfloat16' else ''}) kernel {ms:.3f} "
            f"ms ({tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} of its bound) plain {plain_ms:.3f} "
            f"ms library (SDPA) {library_ms:.3f} ms bound {bound_ms:.3f} ms ({bound_by}, {dt} "
            f"peak; {f32_ms:.3f} ms at the f32 CUDA-core peak)",
            flush=True,
        )
        del q, k, v, library
        torch.cuda.empty_cache()
    return cases


# The inference slice: H2O-Danube3-4B (arXiv:2401.16818) at its published
# widths and all 24 layers; only the number of requests and the generated
# length are cut.
INFER = {"arch": "h2o_danube3_4b", "score_seq": 8192, "serve_batch": 2,
         "prompt": 4608, "gen": 16, "seed": 0}
# (b) f32 logits, kernel route vs the plain chunked route: each of the 24
# layers' attention sums up to 4096 terms in another order (a disagreement
# of order sqrt(4096) 2**-24 ~ 4e-6 of its output), and the residual
# stream carries it through the later layers; 1e-3 x max|logits| leaves a
# wide margin over that and still fails any masking or indexing fault,
# which moves logits by O(1).
ROUTE_TOL = 1e-3
# (d) f32 prefill (chunked attention) and decode (dense attention over the
# ring cache) against the forward through the kernel: three summation
# orders of the same f32 math, as (b); test_arch_smoke.py holds the reduced
# model to 1e-3 on logits of the same O(1-5) size.
DECODE_TOL = 1e-3


def timed_forward(torch, model, params, batch) -> float:
    """ms of one forward on the card's timeline (CUDA events)."""
    with torch.no_grad():
        _, ms = timed(torch, lambda: model.forward(params, batch))
    return ms


def op_shares(torch, model, params, batch, names) -> tuple[float, dict]:
    """(forward ms, {op: (ms inside it, calls)}): one forward on the card's
    timeline, with CUDA events around the whole and around each call of
    each op in ``names`` that ``models.blocks`` makes in it."""
    from repro_torch.models import blocks

    ops = {name: getattr(blocks, name) for name in names}
    spans = {name: [] for name in names}

    def timed_op(name):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = ops[name](*args, **kwargs)
            end.record()
            spans[name].append((start, end))
            return out
        return call

    for name in names:
        setattr(blocks, name, timed_op(name))
    try:
        fwd_ms = timed_forward(torch, model, params, batch)
    finally:
        for name, op in ops.items():
            setattr(blocks, name, op)
    return fwd_ms, {name: (sum(a.elapsed_time(b) for a, b in spans[name]), len(spans[name]))
                    for name in names}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def inference_slice(torch, np, card: str) -> int:
    """Score, serve and check the full-width model; returns the scoring
    forward's flash_attention launch count (the main path)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step

    cfg = dataclasses.replace(get_config(INFER["arch"]), use_pallas_kernels=True)
    s = INFER["score_seq"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(INFER["seed"]))
    stream = iter(TokenStream(cfg.vocab_size, s, 1, seed=INFER["seed"]))
    host = next(stream)
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV heads of "
          f"{cfg.hd}, window {cfg.window}, {cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through the kernel.
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches = fa.launch_count()
    loss = float(loss)
    if main_launches != cfg.num_layers or not np.isfinite(loss):
        raise AssertionError(f"scoring forward: {main_launches} flash_attention launches "
                             f"(expected {cfg.num_layers}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("flash_attention",))
    attn_ms, calls = shares["flash_attention"]
    plain_model = build_model(dataclasses.replace(cfg, use_pallas_kernels=False))
    plain_fwd_ms = timed_forward(torch, plain_model, params, batch)
    print(
        f"(a) scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} flash_attention "
        f"launches, peak {peak_gb:.2f} GB; {fwd_ms:.3f} ms (CUDA events) = "
        f"flash_attention {attn_ms:.3f} ms over {calls} calls ({attn_ms / fwd_ms:.1%}, CUDA "
        f"events around each call in this forward) + the rest {fwd_ms - attn_ms:.3f} ms; "
        f"through the plain chunked attention {plain_fwd_ms:.3f} ms",
        flush=True,
    )

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain attention, as in the reference, so no kernel launches.
    fa.reset_launch_count()
    res = serve.serve(INFER["arch"], batch=INFER["serve_batch"], prompt_len=INFER["prompt"],
                      gen_len=INFER["gen"], reduced=False, seed=INFER["seed"])
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (INFER["serve_batch"], INFER["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) serve B={INFER['serve_batch']} prompt {INFER['prompt']} (window {cfg.window}: "
          f"the ring wraps) gen {INFER['gen']} bf16: prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_tokens_per_s']:.1f} tok/s ({res['decode_s']:.3f} s), "
          f"{fa.launch_count()} flash_attention launches", flush=True)
    del params
    torch.cuda.empty_cache()

    # (b) f32: the kernel route against the plain chunked route.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(INFER["seed"]))
    plain32 = build_model(dataclasses.replace(cfg32, use_pallas_kernels=False))
    with torch.no_grad():
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
    err, scale = max_err(routed, plain)
    del routed, plain
    if not err <= ROUTE_TOL * scale:
        raise AssertionError(f"(b) f32 logits, kernel vs plain route: {err:.3e} > "
                             f"{ROUTE_TOL} x {scale:.3e}")
    print(f"(b) f32 forward S={s}: logits kernel route vs plain chunked route max abs err "
          f"{err:.3e} (max|logits| {scale:.3e}, tol {ROUTE_TOL} x max)", flush=True)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernel over the prompt and the generated tokens.
    bsz, n0, gen = INFER["serve_batch"], INFER["prompt"], INFER["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(INFER["seed"]).integers(0, cfg.vocab_size, (bsz, n0)),
        device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []      # host ms until a step returns / until the card ran it
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        fa.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)                     # positions n0-1 .. n0+gen-1
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if fa.launch_count() != cfg.num_layers or not err <= DECODE_TOL * scale:
        raise AssertionError(f"(d) f32 prefill+decode vs forward: {err:.3e} > "
                             f"{DECODE_TOL} x {scale:.3e}, or {fa.launch_count()} launches")
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (ragged S, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {DECODE_TOL} x max) on {card}", flush=True)
    # Where a decode step's time goes: an enqueue time close to the step
    # time means the host, not the card, sets the pace.  The first step
    # warms up.
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params32))
    print(f"(d) decode step B={bsz} f32 (median of {len(total)}): {total[len(total) // 2]:.3f} ms "
          f"synchronized, of which {enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue "
          f"it; reading the f32 weights once takes "
          f"{weight_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at HBM rate", flush=True)
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches


# ssm_scan at the full-width Zamba2-2.7B Mamba2 layer (32 heads of dh =
# 5120 / 32 = 160, state 64, chunk 256): (B, S, H, dh, ds, chunk, valid
# steps, dtype).  4352 is the scoring forward's padding of S = 4100 to
# whole chunks (the steps past 4100 zero, dt = 0); chunk 64 is
# test_kernel_integration.py's and chunk 16 the reduced configs', at the
# reduced width (4 heads of 128, state 16); dh 80 leaves a partial tile.
SSM_CASES = [(1, 8192, 32, 160, 64, 256, None, "bfloat16"),
             (1, 8192, 32, 160, 64, 256, None, "float32"),
             (2, 8192, 32, 160, 64, 256, None, "bfloat16"),
             (1, 4352, 32, 160, 64, 256, 4100, "bfloat16"),
             (2, 512, 4, 128, 16, 64, None, "float32"),
             (2, 256, 4, 128, 16, 16, None, "float32"),
             (1, 2048, 32, 80, 64, 256, None, "bfloat16")]
SSM_HEADLINE = SSM_CASES[0]
# ssm_scan tolerance, per element: |kernel - plain| <= rel |plain| + eps
# y_abs, where y_abs (h_abs for the final state) is the plain scan of |x|,
# |B| and |C|: the sum of the magnitudes of every term that forms the
# element.  eps = 2**-20 max|la| + (chunk + ds) 2**-24.  The first term is
# la's: the kernel forms the in-chunk cumulative sum la = cumsum(a dt) in
# another order than torch.cumsum, and a term's decay exp(la_t - la_s)
# takes the rounding of the difference as a relative error.  la reaches
# about -870 at the headline (a = -16 over 256 steps), where an f32 ulp is
# 6.1e-5, and the run prints the largest |kernel - plain| / |terms| it
# meets (about one such ulp); 2**-20 max|la| is 8 ulps.  The second is an
# f32 sum of chunk + ds terms in another order.  bf16 adds rel = 2**-7: both versions round one f32
# result to bf16 (one bf16 ulp apart at a rounding boundary).
SSM_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def ssm_inputs(torch, b, s, h, dh, ds, valid, dtype, seed):
    """The layer's distributions: x, B, C ~ N(0, 1) in ``dtype``, dt =
    softplus(N(0, 1) - 2) and a = -linspace(1, 16, H) (the init's
    dt_bias and a_log) in f32; steps past ``valid`` zero, dt = 0."""
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, dh), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda") - 2.0)
    bm = torch.randn((b, s, ds), generator=gen, device="cuda")
    cm = torch.randn((b, s, ds), generator=gen, device="cuda")
    if valid is not None:
        for t in (x, dt, bm, cm):
            t[:, valid:] = 0.0
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x.to(dt_), dt, a, bm.to(dt_), cm.to(dt_)


def ssm_excess(torch, got, want, inputs, chunk: int, dtype: str) -> dict:
    """Max |kernel - plain| and, for y and h, the max over elements of the
    error less its allowance (<= 0 when every element passes)."""
    from repro_torch.kernels.ssm_scan import ssm_scan_ref

    x, dt, a, bm, cm = inputs
    b, s, h, _ = x.shape
    y_abs, h_abs = ssm_scan_ref(x.abs().float(), dt, a, bm.abs().float(), cm.abs().float(),
                                chunk=chunk)
    la_max = (a * dt).reshape(b, s // chunk, chunk, h).sum(2).abs().max().item()
    eps = 2.0**-20 * la_max + (chunk + bm.shape[-1]) * 2.0**-24
    (gy, gh), (wy, wh) = got, want
    dy = (gy.float() - wy.float()).abs()
    dh = (gh - wh).abs()
    rel = (dh / h_abs.clamp_min(1e-30)).max().item()
    if gy.dtype == torch.float32:   # bf16's own rounding would dominate y's ratio
        rel = max(rel, (dy / y_abs.clamp_min(1e-30)).max().item())
    return {"err_y": dy.max().item(), "err_h": dh.max().item(), "eps": eps, "la_max": la_max,
            "rel_terms": rel,
            "excess_y": (dy - SSM_REL[dtype] * wy.float().abs() - eps * y_abs).max().item(),
            "excess_h": (dh - eps * h_abs).max().item()}


def ssm_bound(b, s, h, dh, ds, chunk, dtype) -> tuple[float, str]:
    """x, dt, a, B, C read once, y and the f32 h written once; operations:
    the causal half of C B^T once per (b, chunk), and per (b, h, chunk)
    the causal half of the scores' product with x, the inter-chunk C h^T
    and the state update x^T B, at the peak rate of the inputs' type."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    ops = 2.0 * b * nc * tri * ds + 2.0 * b * h * nc * (tri * dh + 2 * chunk * ds * dh)
    nbytes = ((2 * b * s * h * dh + 2 * b * s * ds) * elem_bytes(dtype)
              + 4 * (b * s * h + h + b * h * dh * ds))
    return roofline(ops, nbytes, dtype)


def ssm_kernel_cases(torch):
    """ssm_scan at the hybrid's shapes, each held against its plain
    version and timed beside it and beside its bound; no single library
    call computes it."""
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda, ssm_scan_ref

    cases = []
    for n, (b, s, h, dh, ds, chunk, valid, dt) in enumerate(SSM_CASES):
        inputs = ssm_inputs(torch, b, s, h, dh, ds, valid, dt, seed=4 + n)
        got = ssm_scan_cuda(*inputs, chunk=chunk)
        want = ssm_scan_ref(*inputs, chunk=chunk)
        again = ssm_scan_cuda(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        ex = ssm_excess(torch, got, want, inputs, chunk, dt)
        shape = f"({b},{s},{h},{dh}) ds {ds} chunk {chunk} {dt}"
        if not (ex["excess_y"] <= 0.0 and ex["excess_h"] <= 0.0 and got[0].dtype == inputs[0].dtype
                and torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            raise AssertionError(
                f"ssm_scan {shape}: an element of y or h exceeds |kernel - plain| <= "
                f"{SSM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms| by {ex['excess_y']:.3e} "
                f"/ {ex['excess_h']:.3e}, or two launches differ"
            )
        del got, want, again
        big = s >= 4096
        ms = time_calls(torch, lambda: ssm_scan_cuda(*inputs, chunk=chunk), 10 if big else 50)
        plain_ms = time_calls(torch, lambda: ssm_scan_ref(*inputs, chunk=chunk), 2 if big else 20)
        bound_ms, bound_by = ssm_bound(b, s, h, dh, ds, chunk, dt)
        f32_ms, _ = ssm_bound(b, s, h, dh, ds, chunk, "float32")
        cases.append({
            "shape": shape, "key": SSM_CASES[n], "max_abs_err": ex["err_y"],
            "max_abs_err_h": ex["err_h"], "max_err_over_terms": ex["rel_terms"],
            "tolerance": f"{SSM_REL[dt]:.3e} |plain| + "
            f"{ex['eps']:.3e} |terms|", "la_max": ex["la_max"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "f32_simt_bound_ms": f32_ms, "blocks": -(-dh // 32) * h * b * (s // chunk),
        })
        print(
            f"ssm_scan {shape}: err y {ex['err_y']:.3e} h {ex['err_h']:.3e}, at most "
            f"{ex['rel_terms']:.3e} of |terms| (tol {cases[-1]['tolerance']} per element, "
            f"max|la| {ex['la_max']:.1f}; bit-identical "
            f"across launches) kernel {ms:.3f} ms ({cases[-1]['blocks']} blocks) plain "
            f"{plain_ms:.3f} ms bound {bound_ms:.3f} ms ({bound_by}, {dt} peak; {f32_ms:.3f} ms "
            f"at the f32 CUDA-core peak)",
            flush=True,
        )
        del inputs
        torch.cuda.empty_cache()
    return cases


# The hybrid slice: Zamba2-2.7B (arXiv:2411.15242) at its published widths
# and all 54 layers (9 periods of 6 Mamba2 layers and the shared attention
# block); only the number of requests and the generated length are cut.
HYBRID = {"arch": "zamba2_2_7b", "score_seq": 8192, "serve_batch": 2,
          "prompt": 4608, "gen": 16, "seed": 0}
# This random-weight model amplifies rounding: one ulp of relative noise
# on its embeddings moves its f32 logits by about 1% of max|logits| ((b)
# prints it), so whole-model logits separate only faults that move them by
# O(1).  (b) holds each of the 54 kernel calls, on the plain route's own
# input, to 1e-3 of its layer's update (la's rounding, see SSM_REL, keeps
# it far below that), and the logits of the two routes, and (d)
# those of prefill + decode against the forward, to 0.1 x max|logits|,
# which a dropped tile, a wrong mask or a stale state exceeds.
HYBRID_LAYER_TOL = 1e-3
HYBRID_LOGITS_TOL = 0.1


def hybrid_slice(torch, np, card: str) -> tuple[int, dict]:
    """Score, serve and check the full-width hybrid; returns the scoring
    forward's ssm_scan launch count (the main path) and where its time
    goes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import blocks, build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step
    from repro_torch.models.transformer import layer_params
    from repro_torch.nn.layers import embed_lookup

    cfg = dataclasses.replace(get_config(HYBRID["arch"]), use_pallas_kernels=True)
    s, seed = HYBRID["score_seq"], HYBRID["seed"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, s, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    mamba_layers = cfg.num_layers
    attn_calls = model.num_periods
    print(f"{cfg.name}: {cfg.param_count() / 1e9:.3f} B parameters, {mamba_layers} Mamba2 "
          f"layers (d_inner {cfg.d_inner_eff}, {cfg.ssm_heads} heads of "
          f"{cfg.d_inner_eff // cfg.ssm_heads}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}) "
          f"and {attn_calls} calls of one shared attention block ({cfg.num_heads} heads of "
          f"{cfg.hd}, window {cfg.window}), d_model {cfg.d_model}, {cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through both kernels.
    torch.cuda.reset_peak_memory_stats()
    ss.reset_launch_count()
    fa.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches, attn_launches = ss.launch_count(), fa.launch_count()
    loss = float(loss)
    if main_launches != mamba_layers or attn_launches != attn_calls or not np.isfinite(loss):
        raise AssertionError(f"hybrid scoring forward: {main_launches} ssm_scan and "
                             f"{attn_launches} flash_attention launches (expected "
                             f"{mamba_layers} and {attn_calls}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("ssm_scan", "flash_attention"))
    (ssm_ms, ssm_calls), (attn_ms, a_calls) = shares["ssm_scan"], shares["flash_attention"]
    plain_fwd_ms = timed_forward(
        torch, build_model(dataclasses.replace(cfg, use_pallas_kernels=False)), params, batch)
    rest = fwd_ms - ssm_ms - attn_ms
    print(
        f"(a) hybrid scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} ssm_scan "
        f"and {attn_launches} flash_attention launches, peak {peak_gb:.2f} GB; "
        f"{fwd_ms:.3f} ms (CUDA events) = ssm_scan {ssm_ms:.3f} ms over {ssm_calls} calls "
        f"({ssm_ms / fwd_ms:.1%}) + flash_attention {attn_ms:.3f} ms over {a_calls} calls "
        f"({attn_ms / fwd_ms:.1%}; CUDA events around each call in this forward) + the rest "
        f"{rest:.3f} ms; through the plain scan and attention {plain_fwd_ms:.3f} ms",
        flush=True,
    )
    split = {"forward_ms": fwd_ms, "ssm_scan_ms": ssm_ms, "ssm_scan_calls": ssm_calls,
             "flash_attention_ms": attn_ms, "flash_attention_calls": a_calls, "rest_ms": rest,
             "plain_forward_ms": plain_fwd_ms, "peak_gb": peak_gb}

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain scan, recurrence and attention, as in the reference.
    ss.reset_launch_count()
    fa.reset_launch_count()
    res = serve.serve(HYBRID["arch"], batch=HYBRID["serve_batch"], prompt_len=HYBRID["prompt"],
                      gen_len=HYBRID["gen"], reduced=False, seed=seed)
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (HYBRID["serve_batch"], HYBRID["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"hybrid serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) hybrid serve B={HYBRID['serve_batch']} prompt {HYBRID['prompt']} (window "
          f"{cfg.window}: the ring wraps) gen {HYBRID['gen']} bf16: prefill "
          f"{res['prefill_s']:.3f} s, decode {res['decode_tokens_per_s']:.1f} tok/s "
          f"({res['decode_s']:.3f} s), {ss.launch_count()} ssm_scan and {fa.launch_count()} "
          f"flash_attention launches", flush=True)
    split.update(prefill_s=res["prefill_s"], decode_tokens_per_s=res["decode_tokens_per_s"])
    del params
    torch.cuda.empty_cache()

    # (b) f32: each kernel call against the plain scan on the same input,
    # then the kernel route's logits against the plain route's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    plain_cfg = dataclasses.replace(cfg32, use_pallas_kernels=False)
    plain32 = build_model(plain_cfg)
    layer_gap = 0.0
    with torch.no_grad():
        x = embed_lookup(params32["embed"], batch["tokens"])
        positions = torch.arange(s, device="cuda")
        for i in range(model32.num_periods):
            for j in range(model32.per_period):
                mp = layer_params(layer_params(params32["mamba"], i), j)
                plain_x, _ = blocks.apply_mamba_layer(mp, x, plain_cfg, None)
                routed_x, _ = blocks.apply_mamba_layer(mp, x, cfg32, None)
                gap = ((routed_x - plain_x).abs().max() / (plain_x - x).abs().max()).item()
                layer_gap = max(layer_gap, gap)
                x = plain_x
            x, _, _ = blocks.apply_transformer_layer(params32["shared_attn"], x, positions,
                                                     plain_cfg, None)
        del x, plain_x, routed_x
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
        err, scale = max_err(routed, plain)
        del routed
        noise = torch.randn(params32["embed"].shape, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        nudged, _ = plain32.forward(dict(params32, embed=params32["embed"] * (1 + 2**-24 * noise)),
                                    {"tokens": batch["tokens"]})
        ulp_gap, _ = max_err(nudged, plain)
        del plain, nudged, noise
    if not (layer_gap <= HYBRID_LAYER_TOL and err <= HYBRID_LOGITS_TOL * scale):
        raise AssertionError(f"(b) f32 kernel vs plain route: a layer's update differs by "
                             f"{layer_gap:.3e} (tol {HYBRID_LAYER_TOL}), logits by {err:.3e} "
                             f"(tol {HYBRID_LOGITS_TOL} x {scale:.3e})")
    print(f"(b) f32 forward S={s}: each of the {mamba_layers} Mamba2 layers, kernel vs plain scan "
          f"on the same input, within {layer_gap:.3e} of the layer's update (tol "
          f"{HYBRID_LAYER_TOL}); logits kernel route vs plain route max abs err {err:.3e} "
          f"(max|logits| {scale:.3e}, tol {HYBRID_LOGITS_TOL} x max); one ulp of noise on the "
          f"embeddings moves the plain route's logits by {ulp_gap:.3e}", flush=True)
    split.update(layer_gap=layer_gap, route_err=err / scale, ulp_gap=ulp_gap / scale)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernels over the prompt and the generated tokens.
    bsz, n0, gen = HYBRID["serve_batch"], HYBRID["prompt"], HYBRID["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0)), device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        ss.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if ss.launch_count() != mamba_layers or not err <= HYBRID_LOGITS_TOL * scale:
        raise AssertionError(f"(d) hybrid f32 prefill+decode vs forward: {err:.3e} > "
                             f"{HYBRID_LOGITS_TOL} x {scale:.3e}, or {ss.launch_count()} "
                             f"ssm_scan launches")
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (padded scan, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {HYBRID_LOGITS_TOL} x max); a decode step B={bsz} "
          f"(median of {len(total)}) {total[len(total) // 2]:.3f} ms synchronized, of which "
          f"{enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue it, on {card}",
          flush=True)
    split.update(decode_err=err / scale, decode_step_ms=total[len(total) // 2],
                 decode_enqueue_ms=enqueue[len(enqueue) // 2])
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches, split


# mlstm_scan at the full-width xLSTM-350M mLSTM layer (4 heads of dk = dv
# = 1024 / 4 = 256, chunk 256): (B, S, H, dk, dv, chunk, valid steps,
# dtype).  4608 is the served prompt; 4352 the scoring forward's padding
# of S = 4100 to whole chunks (steps past 4100: q, k, v = 0, i_pre = -1e9,
# f_pre = +1e9); chunk 16 is the reduced config's (4 heads of 64); the
# last case has dk != dv.
MLSTM_CASES = [(1, 8192, 4, 256, 256, 256, None, "bfloat16"),
               (1, 8192, 4, 256, 256, 256, None, "float32"),
               (2, 4608, 4, 256, 256, 256, None, "bfloat16"),
               (1, 4352, 4, 256, 256, 256, 4100, "bfloat16"),
               (2, 128, 4, 64, 64, 16, None, "float32"),
               (1, 512, 2, 64, 128, 64, None, "float32")]
MLSTM_HEADLINE = MLSTM_CASES[0]
# mlstm_scan tolerance, per element: |kernel - plain| <= rel |plain| + eps
# (num_abs + |plain| (den_abs + D)) / D for y, where num_abs and den_abs
# are the plain numerator and denominator computed on |q|, |k|, |v| (the
# sum of the magnitudes of every term that forms them) and D = max(|den|,
# e^{-m_t}) the plain version's floored denominator: y = num / D, so an
# error of eps num_abs in num and eps den_abs in den moves y by eps
# (num_abs + |y| den_abs) / D, and an error of eps in m_t moves the floor
# by eps D.  For the state, eps times the plain state of |k|, |v| (C, n)
# and eps (max|F| + |m|) for m.  eps = 2**-20 max|F| + (2 chunk + dk)
# 2**-24.  The first term is F's: the kernel forms F = cumsum(logsigmoid(
# f_pre)) in another order than torch.cumsum, and each weight e^{F_t - F_s
# + i_s - m_t} takes the rounding of F as a relative error; 2**-20 max|F|
# is 16 ulps of the largest |F| (about 20 at chunk 256).  The second is an
# f32 sum of up to 2 chunk + dk terms in another order (the scores' dk,
# the chunk's keys and the carried state's chunk).  bf16 adds rel =
# 2**-7: both versions round one f32 result to bf16.
MLSTM_REL = {"float32": 0.0, "bfloat16": 2.0**-7}


def mlstm_inputs(torch, b, s, h, dk, dv, valid, dtype, seed):
    """The layer's distributions: q, k, v ~ N(0, 1) in ``dtype`` (rms-normed
    activations through 1/sqrt(d)-scaled weights), i_pre ~ N(0, 1) and
    f_pre ~ N(3, 1) (the +3 forget bias) in f32; steps past ``valid`` are
    the model's padding."""
    dt_ = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn((b, s, h, dk), generator=gen, device="cuda") for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device="cuda")
    i_pre = torch.randn((b, s, h), generator=gen, device="cuda")
    f_pre = torch.randn((b, s, h), generator=gen, device="cuda") + 3.0
    if valid is not None:
        for t in (q, k, v):
            t[:, valid:] = 0.0
        i_pre[:, valid:] = -1e9
        f_pre[:, valid:] = 1e9
    return q.to(dt_), k.to(dt_), v.to(dt_), i_pre, f_pre


def mlstm_excess(torch, got, want, inputs, chunk: int, dtype: str) -> dict:
    """Max |kernel - plain| and, for y and the state, the max over elements
    of the error less its allowance (<= 0 when every element passes)."""
    from repro_torch.nn.xlstm import init_mlstm_state, mlstm_terms

    q, k, v, i_pre, f_pre = inputs
    b, s, h, dk = q.shape
    zero = init_mlstm_state(b, h, dk, v.shape[-1], device=q.device)
    _, den, floor, _ = mlstm_terms(q, k, v, i_pre, f_pre, zero, chunk=chunk)
    num_a, den_a, _, st_a = mlstm_terms(q.abs(), k.abs(), v.abs(), i_pre, f_pre, zero,
                                        chunk=chunk)
    d = torch.maximum(den.abs(), floor)
    f_max = (torch.nn.functional.logsigmoid(f_pre).reshape(b, s // chunk, chunk, h)
             .cumsum(2).abs().max().item())
    eps = 2.0**-20 * f_max + (2 * chunk + dk) * 2.0**-24
    (gy, (gc, gn, gm)), (wy, (wc, wn, wm)) = got, want
    wy = wy.float()
    terms_y = num_a / d[..., None] + wy.abs() * ((den_a + d) / d)[..., None]
    dy = (gy.float() - wy).abs()
    diffs = ((gc - wc).abs(), (gn - wn).abs(), (gm - wm).abs())
    terms_state = (st_a.c, st_a.n, f_max + wm.abs())
    rel = max((dd / t.clamp_min(1e-30)).max().item() for dd, t in zip(diffs, terms_state))
    if gy.dtype == torch.float32:   # bf16's own rounding would dominate y's ratio
        rel = max(rel, (dy / terms_y.clamp_min(1e-30)).max().item())
    return {"err_y": dy.max().item(), "err_state": max(dd.max().item() for dd in diffs),
            "eps": eps, "f_max": f_max, "rel_terms": rel,
            "excess_y": (dy - MLSTM_REL[dtype] * wy.abs() - eps * terms_y).max().item(),
            "excess_state": max((dd - eps * t).max().item()
                                for dd, t in zip(diffs, terms_state))}


def mlstm_bound(b, s, h, dk, dv, chunk, dtype) -> tuple[float, str]:
    """q, k, v, i_pre, f_pre read once, y and the f32 (C, n, m) written
    once; operations per (b, h, chunk): the causal half of q k^T and of the
    scores' product with v, q C_prev and q . n_prev, and the state update
    k^T v and its n, at the peak rate of the inputs' type."""
    nc, tri = s // chunk, chunk * (chunk + 1) // 2
    ops = 2.0 * b * h * nc * (tri * (dk + dv) + 2 * chunk * dk * dv + 2 * chunk * dk)
    nbytes = ((2 * b * s * h * dk + 2 * b * s * h * dv) * elem_bytes(dtype)
              + 4 * (2 * b * s * h + b * h * (dk * dv + dk + 1)))
    return roofline(ops, nbytes, dtype)


def mlstm_kernel_cases(torch):
    """mlstm_scan at xLSTM's shapes, each held against its plain version and
    timed beside it and beside its bound; no single library call computes
    it."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan_cuda, mlstm_scan_ref

    cases = []
    for n, (b, s, h, dk, dv, chunk, valid, dt) in enumerate(MLSTM_CASES):
        inputs = mlstm_inputs(torch, b, s, h, dk, dv, valid, dt, seed=20 + n)
        got = mlstm_scan_cuda(*inputs, chunk=chunk)
        want = mlstm_scan_ref(*inputs, chunk=chunk)
        again = mlstm_scan_cuda(*inputs, chunk=chunk)
        torch.cuda.synchronize()
        ex = mlstm_excess(torch, got, want, inputs, chunk, dt)
        shape = f"({b},{s},{h},{dk}->{dv}) chunk {chunk} {dt}" + (
            f" valid {valid}" if valid is not None else "")
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(x, y) for x, y in zip(got[1], again[1]))
        if not (ex["excess_y"] <= 0.0 and ex["excess_state"] <= 0.0 and same
                and got[0].dtype == inputs[0].dtype):
            raise AssertionError(
                f"mlstm_scan {shape}: an element of y or (C, n, m) exceeds its allowance "
                f"({MLSTM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms|) by "
                f"{ex['excess_y']:.3e} / {ex['excess_state']:.3e}, or two launches differ"
            )
        if valid is not None and got[0][:, valid:].any():
            raise AssertionError(f"mlstm_scan {shape}: padded rows are not 0")
        del got, want, again
        big = s >= 4096
        ms = time_calls(torch, lambda: mlstm_scan_cuda(*inputs, chunk=chunk), 10 if big else 50)
        plain_ms = time_calls(torch, lambda: mlstm_scan_ref(*inputs, chunk=chunk),
                              2 if big else 20)
        bound_ms, bound_by = mlstm_bound(b, s, h, dk, dv, chunk, dt)
        f32_ms, _ = mlstm_bound(b, s, h, dk, dv, chunk, "float32")
        nc = s // chunk
        cases.append({
            "shape": shape, "key": MLSTM_CASES[n], "max_abs_err": ex["err_y"],
            "max_abs_err_state": ex["err_state"], "max_err_over_terms": ex["rel_terms"],
            "tolerance": f"{MLSTM_REL[dt]:.3e} |plain| + {ex['eps']:.3e} |terms|",
            "f_max": ex["f_max"], "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "f32_simt_bound_ms": f32_ms,
            "blocks": -(-chunk // 64) * b * h * nc * -(-dv // 64),
        })
        print(
            f"mlstm_scan {shape}: err y {ex['err_y']:.3e} state {ex['err_state']:.3e}, at most "
            f"{ex['rel_terms']:.3e} of |terms| (tol {cases[-1]['tolerance']} per element, "
            f"max|F| {ex['f_max']:.1f}; bit-identical across launches) kernel {ms:.3f} ms "
            f"({cases[-1]['blocks']} output blocks) plain {plain_ms:.3f} ms bound "
            f"{bound_ms:.3f} ms ({bound_by}, {dt} peak; {f32_ms:.3f} ms at the f32 CUDA-core "
            f"peak)",
            flush=True,
        )
        del inputs
        torch.cuda.empty_cache()
    return cases


# The xLSTM slice: xLSTM-350M (arXiv:2405.04517) at its published widths
# and all 24 layers (4 periods of 5 mLSTM layers and one sLSTM layer);
# only the number of requests and the generated length are cut.
XLSTM = {"arch": "xlstm_350m", "score_seq": 8192, "serve_batch": 2,
         "prompt": 4608, "gen": 16, "seed": 0}
# (b) holds each of the 20 kernel calls, on the plain route's own input, to
# 1e-3 of its layer's update (F's rounding, see MLSTM_REL, keeps it far
# below that), and the logits of the two routes, and (d) those of prefill
# + decode against the forward, to 0.1 x max|logits|, as the hybrid's: a
# random-weight model may amplify rounding ((b) prints its response to
# one ulp of noise on the embeddings), and a dropped tile, a wrong mask or
# a stale state moves the logits by O(1).
XLSTM_LAYER_TOL = 1e-3
XLSTM_LOGITS_TOL = 0.1


def xlstm_slice(torch, np, card: str) -> tuple[int, dict]:
    """Score, serve and check the full-width xLSTM; returns the scoring
    forward's mlstm_scan launch count (the main path) and where its time
    goes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.launch import serve
    from repro_torch.models import blocks, build_model
    from repro_torch.models.steps import make_loss_fn, make_serve_step
    from repro_torch.models.transformer import layer_params
    from repro_torch.nn.layers import embed_lookup

    cfg = dataclasses.replace(get_config(XLSTM["arch"]), use_pallas_kernels=True)
    s, seed = XLSTM["score_seq"], XLSTM["seed"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    host = next(iter(TokenStream(cfg.vocab_size, s, 1, seed=seed)))
    batch = {k: torch.as_tensor(a, device="cuda") for k, a in host.items()}
    mlstm_layers = model.num_periods * model.mlstm_per_period
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.3f} M parameters, {mlstm_layers} mLSTM layers "
          f"({cfg.num_heads} heads of dk = dv = {cfg.hd}, chunk {cfg.ssm_chunk}) and "
          f"{model.num_periods} sLSTM layers ({cfg.num_heads} heads of "
          f"{cfg.d_model // cfg.num_heads}), d_model {cfg.d_model}, vocab {cfg.padded_vocab}, "
          f"{cfg.dtype}", flush=True)

    # (a) The main path: the scoring forward through the kernel.
    torch.cuda.reset_peak_memory_stats()
    ms.reset_launch_count()
    with torch.no_grad():
        loss = make_loss_fn(model)(params, batch)
    torch.cuda.synchronize()
    main_launches = ms.launch_count()
    loss = float(loss)
    if main_launches != mlstm_layers or not np.isfinite(loss):
        raise AssertionError(f"xlstm scoring forward: {main_launches} mlstm_scan launches "
                             f"(expected {mlstm_layers}), loss {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, shares = op_shares(torch, model, params, batch, ("mlstm_scan", "apply_slstm_layer"))
    (scan_ms, scan_calls), (slstm_ms, slstm_calls) = (shares["mlstm_scan"],
                                                      shares["apply_slstm_layer"])
    plain_fwd_ms = timed_forward(
        torch, build_model(dataclasses.replace(cfg, use_pallas_kernels=False)), params, batch)
    rest = fwd_ms - scan_ms - slstm_ms
    print(
        f"(a) xlstm scoring forward B=1 S={s} bf16: loss {loss:.4f}, {main_launches} mlstm_scan "
        f"launches, peak {peak_gb:.2f} GB; {fwd_ms:.3f} ms (CUDA events) = mlstm_scan "
        f"{scan_ms:.3f} ms over {scan_calls} calls ({scan_ms / fwd_ms:.1%}) + sLSTM layers "
        f"{slstm_ms:.3f} ms over {slstm_calls} calls ({slstm_ms / fwd_ms:.1%}; CUDA events "
        f"around each call in this forward) + the rest {rest:.3f} ms; through the plain scan "
        f"{plain_fwd_ms:.3f} ms",
        flush=True,
    )
    split = {"forward_ms": fwd_ms, "mlstm_scan_ms": scan_ms, "mlstm_scan_calls": scan_calls,
             "slstm_ms": slstm_ms, "slstm_calls": slstm_calls, "rest_ms": rest,
             "plain_forward_ms": plain_fwd_ms, "peak_gb": peak_gb, "loss": loss}

    # (c) Serving through the launcher's entry point: prefill and decode
    # take the plain scan and the recurrences, as in the reference.
    ms.reset_launch_count()
    res = serve.serve(XLSTM["arch"], batch=XLSTM["serve_batch"], prompt_len=XLSTM["prompt"],
                      gen_len=XLSTM["gen"], reduced=False, seed=seed)
    toks = res["tokens"]
    if res["device"] != "cuda" or toks.shape != (XLSTM["serve_batch"], XLSTM["gen"]) \
            or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"xlstm serve: tokens {toks.shape} on {res['device']}")
    print(f"(c) xlstm serve B={XLSTM['serve_batch']} prompt {XLSTM['prompt']} gen "
          f"{XLSTM['gen']} bf16: prefill {res['prefill_s']:.3f} s, decode "
          f"{res['decode_tokens_per_s']:.1f} tok/s ({res['decode_s']:.3f} s), "
          f"{ms.launch_count()} mlstm_scan launches", flush=True)
    split.update(prefill_s=res["prefill_s"], decode_tokens_per_s=res["decode_tokens_per_s"])
    del params
    torch.cuda.empty_cache()

    # (b) f32: each kernel call against the plain scan on the same input,
    # then the kernel route's logits against the plain route's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(torch.Generator(device="cuda").manual_seed(seed))
    plain_cfg = dataclasses.replace(cfg32, use_pallas_kernels=False)
    plain32 = build_model(plain_cfg)
    layer_gap = 0.0
    with torch.no_grad():
        x = embed_lookup(params32["embed"], batch["tokens"])
        for i in range(model32.num_periods):
            for j in range(model32.mlstm_per_period):
                mp = layer_params(layer_params(params32["mlstm"], i), j)
                plain_x, _ = blocks.apply_mlstm_layer(mp, x, plain_cfg, None)
                routed_x, _ = blocks.apply_mlstm_layer(mp, x, cfg32, None)
                gap = ((routed_x - plain_x).abs().max() / (plain_x - x).abs().max()).item()
                layer_gap = max(layer_gap, gap)
                x = plain_x
            x, _ = blocks.apply_slstm_layer(layer_params(params32["slstm"], i), x, plain_cfg,
                                            None)
        del x, plain_x, routed_x
        routed, _ = model32.forward(params32, {"tokens": batch["tokens"]})
        plain, _ = plain32.forward(params32, {"tokens": batch["tokens"]})
        err, scale = max_err(routed, plain)
        del routed
        noise = torch.randn(params32["embed"].shape, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        nudged, _ = plain32.forward(dict(params32, embed=params32["embed"] * (1 + 2**-24 * noise)),
                                    {"tokens": batch["tokens"]})
        ulp_gap, _ = max_err(nudged, plain)
        del plain, nudged, noise
    if not (layer_gap <= XLSTM_LAYER_TOL and err <= XLSTM_LOGITS_TOL * scale):
        raise AssertionError(f"(b) f32 kernel vs plain route: a layer's update differs by "
                             f"{layer_gap:.3e} (tol {XLSTM_LAYER_TOL}), logits by {err:.3e} "
                             f"(tol {XLSTM_LOGITS_TOL} x {scale:.3e})")
    print(f"(b) f32 forward S={s}: each of the {mlstm_layers} mLSTM layers, kernel vs plain scan "
          f"on the same input, within {layer_gap:.3e} of the layer's update (tol "
          f"{XLSTM_LAYER_TOL}); logits kernel route vs plain route max abs err {err:.3e} "
          f"(max|logits| {scale:.3e}, tol {XLSTM_LOGITS_TOL} x max); one ulp of noise on the "
          f"embeddings moves the plain route's logits by {ulp_gap:.3e}", flush=True)
    split.update(layer_gap=layer_gap, route_err=err / scale, ulp_gap=ulp_gap / scale)

    # (d) f32 prefill + greedy decode against the f32 forward through the
    # kernel over the prompt and the generated tokens.
    bsz, n0, gen = XLSTM["serve_batch"], XLSTM["prompt"], XLSTM["gen"]
    prompt = torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, n0)), device="cuda")
    step = make_serve_step(model32)
    enqueue, total = [], []
    with torch.no_grad():
        logits, cache = model32.prefill(params32, {"tokens": prompt}, max_len=n0 + gen)
        steps = [logits[:, -1]]
        tok = torch.argmax(logits[:, -1], dim=-1)
        seq = [tok]
        for _ in range(gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, logits, cache = step(params32, {"tokens": tok.reshape(bsz, 1)}, cache)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits[:, -1])
            seq.append(tok)
        del cache
        full_toks = torch.cat([prompt, torch.stack(seq[:-1], dim=1)], dim=1)
        ms.reset_launch_count()
        full, _ = model32.forward(params32, {"tokens": full_toks})
    got = torch.stack(steps, dim=1)
    want = full[:, n0 - 1:n0 + gen]
    err, scale = max_err(got, want)
    if ms.launch_count() != mlstm_layers or not err <= XLSTM_LOGITS_TOL * scale:
        raise AssertionError(f"(d) xlstm f32 prefill+decode vs forward: {err:.3e} > "
                             f"{XLSTM_LOGITS_TOL} x {scale:.3e}, or {ms.launch_count()} "
                             f"mlstm_scan launches")
    enqueue, total = sorted(enqueue[1:]), sorted(total[1:])
    print(f"(d) f32 prefill {n0} + {gen} decode steps vs the forward over {full_toks.shape[1]} "
          f"tokens (padded scan, kernel route): max abs err {err:.3e} over {gen + 1} positions "
          f"(max|logits| {scale:.3e}, tol {XLSTM_LOGITS_TOL} x max); a decode step B={bsz} "
          f"(median of {len(total)}) {total[len(total) // 2]:.3f} ms synchronized, of which "
          f"{enqueue[len(enqueue) // 2]:.3f} ms for the host to enqueue it, on {card}",
          flush=True)
    split.update(decode_err=err / scale, decode_step_ms=total[len(total) // 2],
                 decode_enqueue_ms=enqueue[len(enqueue) // 2])
    del params32, full, got, want
    torch.cuda.empty_cache()
    return main_launches, split


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
    gram_cases, prop_cases = gram_kernel_cases(torch)
    launches = serve_slice(torch, np, card)
    train_launches = train_slice(torch, card)
    flash_cases = flash_kernel_cases(torch)
    flash_launches = inference_slice(torch, np, card)
    torch.cuda.empty_cache()
    ssm_cases = ssm_kernel_cases(torch)
    ssm_launches, split = hybrid_slice(torch, np, card)
    mlstm_cases = mlstm_kernel_cases(torch)
    mlstm_launches, xlstm_split = xlstm_slice(torch, np, card)

    def entry(name, source, replaces, launches, cases, headline):
        head = next(c for c in cases if c["key"] == headline)
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "shapes": head["shape"],
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"],
            "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            **({"bound_rate": "3xTF32: 3 TF32 products per f32 product at 495 TFLOP/s",
                "f32_bound_ms": head["f32_bound_ms"]} if "f32_bound_ms" in head else {}),
            "library_ms": head["library_ms"],
            "cases": [{k: v for k, v in c.items() if k != "key"} for c in cases],
        }

    csrc = "src/repro_torch/kernels/csrc"
    kernels = [
        entry("matmul_relu", f"{csrc}/matmul_relu.cu",
              "src/repro/kernels/matmul_relu/kernel.py:36", launches, cases, HEADLINE),
        entry("gram", f"{csrc}/gram.cu", "src/repro/kernels/gram/kernel.py:47",
              train_launches["gram"], gram_cases, GRAM_HEADLINE),
        entry("propagate_gram", f"{csrc}/propagate_gram.cu",
              "src/repro/kernels/propagate_gram/kernel.py:55",
              train_launches["propagate_gram"], prop_cases, PROPAGATE_HEADLINE),
        entry("flash_attention", f"{csrc}/flash_attention.cu",
              "src/repro/kernels/flash_attention/kernel.py:75", flash_launches,
              flash_cases, FLASH_HEADLINE),
        entry("ssm_scan", f"{csrc}/ssm_scan.cu", "src/repro/kernels/ssm_scan/kernel.py:69",
              ssm_launches, ssm_cases, SSM_HEADLINE),
        entry("mlstm_scan", f"{csrc}/mlstm_scan.cu",
              "src/repro/kernels/mlstm_scan/kernel.py:87", mlstm_launches, mlstm_cases,
              MLSTM_HEADLINE),
    ]
    kernels[-2]["hybrid_forward"] = split
    kernels[-1]["xlstm_forward"] = xlstm_split
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
