"""The port's CUDA legs: they need an NVIDIA GPU and skip without one.

This file imports neither JAX nor ``repro``, so it also runs on a host
that has only the port's dependencies:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: f32 rtol/atol 1e-5 against the plain version (both sum in
f32, in different orders); bf16 one bf16 ulp, 2**-7 relative, since both
round an f32 sum to bf16 and two orders may leave it on either side of a
rounding boundary.  The Gram kernels are held at 1e-5 x max|G| (their
sums run over J <= 3000 samples; for J = 60000 at 2 sqrt(J) 2**-24 x
max|G| = 2.9e-5, the random-walk growth of an in-order f32 sum of J
terms, which the library GEMM behind the plain version may take).  A bf16 propagate_gram
rounds Y' (one bf16 ulp) but builds G from the f32 Y' in both versions,
so its G keeps the f32 tolerance.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import propagate_gram as pg_mod
from repro_torch.kernels.matmul_relu import (
    launch_count,
    matmul_relu,
    matmul_relu_cuda,
    matmul_relu_ref,
)
from repro_torch.serve import MicroBatcher, ServeEngine, export_artifact

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    return w, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "m,k,n",
    [(1020, 784, 1), (1020, 1020, 8), (1020, 1020, 32), (1020, 1020, 128),
     (1204, 3000, 77), (1, 1, 1), (33, 257, 65)],
)
def test_kernel_matches_plain(cuda, dtype, m, k, n):
    w, x = _operands(m, k, n)
    tw = torch.from_numpy(w).to(cuda, dtype)
    tx = torch.from_numpy(x).to(cuda, dtype)
    before = launch_count()
    got = matmul_relu(tw, tx)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = matmul_relu_ref(tw, tx)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_kernel_keeps_nan(cuda):
    w = torch.tensor([[1.0, 0.0], [-1.0, 0.0]], device=cuda)
    x = torch.tensor([[float("nan")], [1.0]], device=cuda)
    assert torch.isnan(matmul_relu(w, x)).all()


@pytest.mark.cuda
def test_kernel_columns_independent_of_batch_width(cuda):
    """Padding invariance: a column's bits do not depend on n, whatever
    tile shape that n selects."""
    w, x = _operands(1020, 1020, 128)
    tw, tx = torch.from_numpy(w).to(cuda), torch.from_numpy(x).to(cuda)
    full = matmul_relu(tw, tx)
    for n in (1, 8, 16, 17, 32, 64, 65):
        assert torch.equal(matmul_relu(tw, tx[:, :n].contiguous()), full[:, :n]), n


@pytest.mark.cuda
def test_wrapper_rejects_what_kernel_cannot_take(cuda):
    w = torch.zeros((4, 3), device=cuda)
    x = torch.zeros((3, 2), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        matmul_relu_cuda(w.half(), x.half())
    with pytest.raises(TypeError, match="dtype"):
        matmul_relu_cuda(w, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        matmul_relu_cuda(w, torch.zeros((2, 3), device=cuda).t())
    with pytest.raises(ValueError, match=r"\(k, n\)"):
        matmul_relu_cuda(w, torch.zeros((4, 2), device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_relu_cuda(w, x.cpu())


@pytest.mark.cuda
def test_engine_on_card_launches_kernel_per_layer_and_stays_bit_exact(cuda, tmp_path):
    rng = np.random.default_rng(1)
    p, q, n, layers = 784, 10, 1020, 3
    o = [rng.standard_normal((q, p)).astype(np.float32) / 28]
    o += [rng.standard_normal((q, n)).astype(np.float32) / 32 for _ in range(layers)]
    r = [(rng.standard_normal((n - 2 * q, p if l == 0 else n)) / 32).astype(np.float32)
         for l in range(layers)]
    path = str(tmp_path / "stack")
    export_artifact(path, params_from_numpy(o, r, device="cpu"))
    engine = ServeEngine(path, buckets=(8, 32))
    assert engine.device.type == "cuda"
    x = torch.from_numpy(rng.standard_normal((p, 32)).astype(np.float32))
    before = launch_count()
    full = engine.forward(x)
    assert launch_count() == before + layers
    assert torch.equal(full, ssfn.predict(params_from_numpy(o, r, device=cuda), x.to(cuda), q))
    assert torch.equal(engine.forward(x[:, :5]), full[:, :5])
    batcher = MicroBatcher(engine, max_batch=32, max_wait_us=1e9)
    handles = [batcher.submit(x[:, i:i + 1]) for i in range(32)]
    assert torch.equal(torch.cat([h.result() for h in handles], dim=1), full)
    cpu = ServeEngine(path, buckets=(8, 32), device="cpu").forward(x)
    np.testing.assert_allclose(full.cpu().numpy(), cpu.numpy(), **TOL)


# ---------------------------------------------------------------------------
# gram and propagate_gram
# ---------------------------------------------------------------------------


def _gram_tol(j):
    return max(1e-5, 2 * math.sqrt(j) * 2**-24)


def _close_scaled(got, want, rel):
    """max|got - want| <= rel * max|want|, in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


def _features(m, n, j, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n, j)).astype(np.float32)


# (M, n, J): the train's layer-0 launches (decentralized and centralized),
# a full-width propagated layer, and ragged edges.
GRAM_SHAPES = [(20, 784, 3000), (1, 784, 60000), (20, 1020, 3000),
               (3, 33, 65), (1, 1, 1), (2, 130, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,j", GRAM_SHAPES)
def test_gram_matches_plain(cuda, m, n, j):
    y = torch.from_numpy(_features(m, n, j)).to(cuda)
    before = gram_mod.launch_count()
    got = gram_mod.gram(y, mu=1e-3)
    torch.cuda.synchronize()
    assert gram_mod.launch_count() == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n, n)
    _close_scaled(got, gram_mod.gram_ref(y, mu=1e-3), _gram_tol(j))


@pytest.mark.cuda
def test_gram_sums_are_compensated(cuda):
    """60000 non-negative products per entry (ReLU features, the
    centralized layer): the kernel's Kahan-added 32-term chains stay
    within 8 f32 ulps of max|G| of a float64 Gram, where one in-order
    chain drifts by about sqrt(J/3) = 141 ulps."""
    y = torch.relu(torch.from_numpy(_features(1, 64, 60000, seed=10))).to(cuda)
    got = gram_mod.gram(y, mu=1.0).double()
    y64 = y.double()
    want = y64 @ y64.mT + torch.eye(64, dtype=torch.float64, device=cuda)
    assert (got - want).abs().max().item() <= 8 * 2**-24 * want.abs().max().item()


@pytest.mark.cuda
def test_gram_bf16_matches_plain(cuda):
    y = torch.from_numpy(_features(3, 33, 65)).to(cuda, torch.bfloat16)
    got = gram_mod.gram(y, mu=1.0)
    assert got.dtype == torch.float32
    _close_scaled(got, gram_mod.gram_ref(y, mu=1.0), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,j", [(3, 200, 300), (3, 1020, 257), (20, 784, 3000)])
def test_gram_symmetric_and_deterministic(cuda, m, n, j):
    """Exactly symmetric; bit-identical across calls, across batch
    positions, and whether a worker is computed at M=1 or in a batch."""
    y = torch.from_numpy(_features(m, n, j, seed=2)).to(cuda)
    g1 = gram_mod.gram(y, mu=0.5)
    g2 = gram_mod.gram(y, mu=0.5)
    assert torch.equal(g1, g2)
    assert torch.equal(g1, g1.mT)
    rolled = gram_mod.gram(torch.roll(y, 1, dims=0).contiguous(), mu=0.5)
    assert torch.equal(torch.roll(rolled, -1, dims=0), g1)
    for w in range(m):
        assert torch.equal(gram_mod.gram(y[w:w + 1].contiguous(), mu=0.5)[0], g1[w])


# (n, n_prev, M, J): the train's layer-1 and layer-l launches, decentralized
# and centralized, and ragged edges.
PROPAGATE_SHAPES = [(1020, 784, 20, 3000), (1020, 1020, 20, 3000),
                    (1020, 1020, 1, 60000), (33, 257, 3, 65), (1, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_prev,m,j", PROPAGATE_SHAPES)
def test_propagate_gram_matches_plain(cuda, n, n_prev, m, j):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(
        (rng.standard_normal((n, n_prev)) / np.sqrt(n_prev)).astype(np.float32)
    ).to(cuda)
    y = torch.from_numpy(_features(m, n_prev, j, seed=4)).to(cuda)
    before = pg_mod.launch_count()
    y_new, g = pg_mod.propagate_gram(w, y, mu=1.0)
    torch.cuda.synchronize()
    assert pg_mod.launch_count() == before + 1
    assert y_new.shape == (m, n, j) and g.shape == (m, n, n)
    want_y, want_g = pg_mod.propagate_gram_ref(w, y, mu=1.0)
    _close_scaled(y_new, want_y, 1e-5)
    _close_scaled(g, want_g, _gram_tol(j))
    assert torch.equal(g, g.mT)
    assert (y_new >= 0).all()


@pytest.mark.cuda
def test_propagate_gram_bf16_grams_the_unrounded_features(cuda):
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((33, 257)).astype(np.float32) / 16)
    y = torch.from_numpy(_features(3, 257, 65, seed=6))
    w, y = w.to(cuda, torch.bfloat16), y.to(cuda, torch.bfloat16)
    y_new, g = pg_mod.propagate_gram(w, y, mu=1.0)
    want_y, want_g = pg_mod.propagate_gram_ref(w, y, mu=1.0)
    assert y_new.dtype == torch.bfloat16 and g.dtype == torch.float32
    _close_scaled(y_new, want_y, 1e-2)
    _close_scaled(g, want_g, 1e-5)          # f32: G saw no bf16 rounding
    # The tolerance tells the two apart: a Gram of the rounded Y' misses it.
    rounded = want_y.float()
    g_rounded = torch.matmul(rounded, rounded.mT) + torch.eye(33, device=cuda)
    assert (g_rounded - want_g).abs().max() > 1e-5 * want_g.abs().max()


@pytest.mark.cuda
def test_propagate_gram_deterministic_per_worker(cuda):
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32) / 14).to(cuda)
    y = torch.from_numpy(_features(3, 200, 129, seed=8)).to(cuda)
    y1, g1 = pg_mod.propagate_gram(w, y, mu=1.0)
    y2, g2 = pg_mod.propagate_gram(w, y, mu=1.0)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
    y_one, g_one = pg_mod.propagate_gram(w, y[2:].contiguous(), mu=1.0)
    assert torch.equal(y_one[0], y1[2]) and torch.equal(g_one[0], g1[2])
    # The Gram pass of the fused op is the gram kernel on the f32 Y'.
    assert torch.equal(gram_mod.gram(y1, mu=1.0), g1)


def _ulps_of_max(got, want):
    """max|got - want| in f32 ulps (2**-24) of max|want|."""
    return ((got.double() - want).abs().max() / (2**-24 * want.abs().max())).item()


def _gram64(y):
    y64 = y.double()
    return y64 @ y64.mT


@pytest.mark.cuda
@pytest.mark.parametrize("n", [127, 128, 129, 1020])
def test_gram_exactly_symmetric_on_ragged_diagonal_tiles(cuda, n):
    """The 3xTF32 sums for (i, k) and (k, i) take hi and lo in opposite
    roles; the kernel mirrors every tile, diagonal tiles included."""
    y = torch.from_numpy(_features(2, n, 300, seed=n)).to(cuda)
    g = gram_mod.gram(y, mu=1.0)
    assert torch.equal(g, g.mT)
    _close_scaled(g, gram_mod.gram_ref(y, mu=1.0), _gram_tol(300))
    y_new, g = pg_mod.propagate_gram(
        torch.from_numpy(_features(1, n, n, seed=1)[0] / np.float32(n**0.5)).to(cuda),
        y, mu=1.0)
    assert torch.equal(g, g.mT)


@pytest.mark.cuda
def test_gram_worker_bits_do_not_depend_on_the_batch_where_j_is_sliced(cuda):
    """J = 60000 is cut into slices of a fixed length whose partial sums a
    second pass adds: a worker's G at M=1 equals its G at M=3 bit for bit."""
    y = torch.relu(torch.from_numpy(_features(3, 130, 60000, seed=11))).to(cuda)
    batch = gram_mod.gram(y, mu=1.0)
    assert torch.equal(batch, batch.mT)
    for w in range(3):
        assert torch.equal(gram_mod.gram(y[w:w + 1].contiguous(), mu=1.0)[0], batch[w])


@pytest.mark.cuda
def test_propagate_gram_within_8_ulps_of_a_float64_forward(cuda):
    """The centralized layer (M=1, J=60000) of ReLU features: Y' within 8
    f32 ulps of max|Y'| and G within 8 ulps of max|G| of float64."""
    rng = np.random.default_rng(13)
    w = torch.from_numpy(
        (rng.standard_normal((1020, 1020)) / np.sqrt(1020)).astype(np.float32)).to(cuda)
    y = torch.relu(torch.from_numpy(_features(1, 1020, 60000, seed=14))).to(cuda)
    y_new, g = pg_mod.propagate_gram(w, y, mu=1.0)
    y64 = torch.relu(w.double() @ y.double())
    assert _ulps_of_max(y_new, y64) <= 8
    g64 = _gram64(y64) + torch.eye(1020, dtype=torch.float64, device=cuda)
    assert _ulps_of_max(g, g64) <= 8


@pytest.mark.cuda
def test_bf16_instances_take_one_exact_product(cuda):
    """A bf16 value is exact in TF32 and a product of two is exact in f32,
    so the bf16 Gram (one product per pair) keeps the f32 bar against a
    float64 Gram of the same values, as does propagate_gram's bf16 G,
    built from the f32 Y' before rounding."""
    y = torch.relu(torch.from_numpy(_features(1, 64, 60000, seed=15))).to(cuda, torch.bfloat16)
    g = gram_mod.gram(y, mu=1.0)
    want = _gram64(y) + torch.eye(64, dtype=torch.float64, device=cuda)
    assert torch.equal(g, g.mT) and _ulps_of_max(g, want) <= 8
    rng = np.random.default_rng(16)
    w = torch.from_numpy((rng.standard_normal((130, 200)) / 14).astype(np.float32))
    w = w.to(cuda, torch.bfloat16)
    x = torch.relu(torch.from_numpy(_features(2, 200, 3000, seed=17))).to(cuda, torch.bfloat16)
    y_new, g = pg_mod.propagate_gram(w, x, mu=1.0)
    y64 = torch.relu(w.double() @ x.double())
    _close_scaled(y_new, y64.float(), 1e-2)
    assert torch.equal(g, g.mT)
    assert _ulps_of_max(g, _gram64(y64) + torch.eye(130, dtype=torch.float64, device=cuda)) <= 8


# Every f32 bit pattern through tc::split_tf32, against cvt.rna.tf32.f32
# for finite x; for a NaN or inf x, lo must be NaN.  bad[0] counts finite
# mismatches, bad[1] non-finite values whose lo is not NaN.
_SPLIT_CHECK_CU = r"""
#include "tensor_core.cuh"

__global__ void split_mismatches(unsigned long long* bad) {
  unsigned long long finite = 0, nonfinite = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)i);
    uint32_t hi, lo;
    tc::split_tf32(x, hi, lo);
    if (isfinite(x)) {
      uint32_t h, l;
      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
      asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(x - __uint_as_float(h)));
      finite += hi != h || lo != l;
    } else {
      nonfinite += !isnan(__uint_as_float(lo));
    }
  }
  atomicAdd(bad, finite);
  atomicAdd(bad + 1, nonfinite);
}

extern "C" int split_check(unsigned long long* host) {
  unsigned long long* bad;
  if (cudaMalloc(&bad, 2 * sizeof(*bad)) != cudaSuccess) return 1;
  cudaMemset(bad, 0, 2 * sizeof(*bad));
  split_mismatches<<<132 * 8, 256>>>(bad);
  const cudaError_t err = cudaMemcpy(host, bad, 2 * sizeof(*bad), cudaMemcpyDeviceToHost);
  cudaFree(bad);
  return err != cudaSuccess;
}
"""


@pytest.mark.cuda
def test_tf32_split_rounds_as_cvt_rna_and_keeps_non_finite_values(cuda, tmp_path):
    """The Gram kernels' two-operation TF32 rounding equals the card's
    cvt.rna.tf32.f32 on all 2**32 finite f32 values, for hi and for lo;
    a NaN (any sign or payload) or an inf gives a NaN lo, which carries
    it into every product."""
    import ctypes
    import subprocess

    from repro_torch.kernels import _build

    src = tmp_path / "split_check.cu"
    src.write_text(_SPLIT_CHECK_CU)
    lib = tmp_path / "libsplit_check.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    counts = (ctypes.c_ulonglong * 2)()
    assert ctypes.CDLL(str(lib)).split_check(counts) == 0
    assert list(counts) == [0, 0]


# A NaN or inf placed in the operands: 0/0 on the card (its NaN,
# 0x7fffffff, whose bits a bare round-half-up carries into -0), the same
# with the sign set, the CPU's NaN (0x7fc00000), and inf.
_NONFINITE = {
    "nan_card": lambda dev: torch.zeros((), device=dev) / 0,
    "nan_negative": lambda dev: torch.tensor(-1, dtype=torch.int32).view(torch.float32).to(dev),
    "nan_cpu": lambda dev: torch.tensor(float("nan")).to(dev),
    "inf": lambda dev: torch.tensor(float("inf")).to(dev),
}


def _same_non_finite(got, want, rel):
    """got is non-finite exactly where want is, NaN wherever want is NaN
    (an inf may come out as NaN), exactly symmetric where it is a Gram,
    and within rel * max|want| on the finite entries."""
    assert (~torch.isfinite(want)).any()
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert not (torch.isnan(want) & ~torch.isnan(got)).any()
    finite = torch.isfinite(want)
    _close_scaled(got[finite], want[finite], rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("value", sorted(_NONFINITE))
def test_gram_kernels_keep_nan_and_inf(cuda, value, dtype):
    """A NaN or inf in Y (gram) or in W (propagate_gram, on non-negative
    features as the train gives it), and a NaN in propagate_gram's Y,
    reach every output they enter, as in the plain version."""
    bad = _NONFINITE[value](cuda)
    y_tol = 1e-5 if dtype == torch.float32 else 1e-2
    y = torch.relu(torch.from_numpy(_features(2, 130, 300, seed=18))).to(cuda)
    y_bad = y.clone()
    y_bad[1, 5, 17] = bad
    y_bad = y_bad.to(dtype)
    g = gram_mod.gram(y_bad, mu=1.0)
    _same_non_finite(g, gram_mod.gram_ref(y_bad, mu=1.0), 1e-5)
    assert torch.equal(g.nan_to_num(), g.mT.nan_to_num())
    rng = np.random.default_rng(19)
    w = torch.from_numpy((rng.standard_normal((140, 130)) / 11).astype(np.float32)).to(cuda)
    w_bad = w.clone()
    w_bad[3, 7] = bad
    operands = [(w_bad, y)]
    if value != "inf":   # relu(W @ Y) of an inf in Y is 0 where W < 0
        operands.append((w, y_bad.float()))
    for ww, yy in operands:
        ww, yy = ww.to(dtype), yy.to(dtype)
        y_new, g = pg_mod.propagate_gram(ww, yy, mu=1.0)
        want_y, want_g = pg_mod.propagate_gram_ref(ww, yy, mu=1.0)
        _same_non_finite(y_new, want_y, y_tol)
        _same_non_finite(g, want_g, 1e-5)
        assert torch.equal(g.nan_to_num(), g.mT.nan_to_num())


@pytest.mark.cuda
def test_gram_wrappers_reject_what_kernels_cannot_take(cuda):
    y = torch.zeros((2, 4, 3), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gram_mod.gram_cuda(y.half(), mu=1.0)
    with pytest.raises(ValueError, match=r"\(M, n, J\)"):
        gram_mod.gram_cuda(y[0], mu=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        gram_mod.gram_cuda(y.mT, mu=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        gram_mod.gram_cuda(y.cpu(), mu=1.0)
    w = torch.zeros((5, 4), device=cuda)
    with pytest.raises(ValueError, match="n_prev"):
        pg_mod.propagate_gram_cuda(w, torch.zeros((2, 3, 3), device=cuda), mu=1.0)
    with pytest.raises(TypeError, match=r"one\s+dtype"):
        pg_mod.propagate_gram_cuda(w, y.to(torch.bfloat16), mu=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        pg_mod.propagate_gram_cuda(w, y.cpu(), mu=1.0)


# ---------------------------------------------------------------------------
# The training slice on the card
# ---------------------------------------------------------------------------


def _train_inputs(device):
    """test_torch_train.py's geometry: P=32, Q=4, n=128, L=3, M=4, J=1024,
    K=30, mu0 = mul = 1e-1, from numpy so both devices get the same data
    and the same R."""
    rng = np.random.default_rng(9)
    p, q, n, layers, m, j = 32, 4, 128, 3, 4, 1024
    x = rng.standard_normal((p, j)).astype(np.float32)
    labels = rng.integers(0, q, j)
    t = np.eye(q, dtype=np.float32)[labels].T.copy()
    r = [(rng.standard_normal((n - 2 * q, p if l == 0 else n)) / np.sqrt(p if l == 0 else n))
         .astype(np.float32) for l in range(layers)]
    cfg = ssfn.SSFNConfig(input_dim=p, num_classes=q, num_layers=layers, hidden=n,
                          mu0=1e-1, mul=1e-1, admm_iters=30)
    xw = torch.from_numpy(x.reshape(p, m, j // m).transpose(1, 0, 2).copy()).to(device)
    tw = torch.from_numpy(t.reshape(q, m, j // m).transpose(1, 0, 2).copy()).to(device)
    return cfg, xw, tw, [torch.from_numpy(a).to(device) for a in r], torch.from_numpy(x).to(device)


@pytest.mark.cuda
def test_card_training_run_equals_cpu_run(cuda):
    """Within test_torch_train.py's tolerances: readouts and predictions
    within a relative gap of 1e-4, argmax agreement >= 0.99; the train
    launches gram once and propagate_gram once per propagated layer."""
    from repro_torch.core import layerwise

    cfg, xw, tw, r, x = _train_inputs(cuda)
    g0, p0 = gram_mod.launch_count(), pg_mod.launch_count()
    card, card_log = layerwise.train_decentralized_ssfn(xw, tw, cfg, r=r)
    assert gram_mod.launch_count() == g0 + 1
    assert pg_mod.launch_count() == p0 + cfg.num_layers
    cfg_c, xw_c, tw_c, r_c, x_c = _train_inputs("cpu")
    cpu, cpu_log = layerwise.train_decentralized_ssfn(xw_c, tw_c, cfg_c, r=r_c)
    for a, b in zip(card.o, cpu.o):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).norm() / b.norm()) <= 1e-4
    got, want = ssfn.predict(card, x, 4).cpu(), ssfn.predict(cpu, x_c, 4)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    assert (got.argmax(0) == want.argmax(0)).float().mean() >= 0.99
    assert card_log.comm_scalars == cpu_log.comm_scalars
    assert np.array_equal(card_log.jitter_levels, cpu_log.jitter_levels)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# Tolerances, per element: |kernel - plain| <= rel |plain| + 1e-5 max|plain|.
# The second term is f32's (both sum in f32, a dot of hd <= 128 terms and
# a softmax over <= S keys, in different orders: a few ulps of the largest
# output).  bf16 adds rel = 2**-7: both round one f32 result to bf16, so
# an element whose f32 values straddle a rounding boundary may differ by
# one bf16 ulp, at most 2**-7 of its size.  Held per element, not against
# max|plain|: a long row averages over thousands of keys and is some 100x
# smaller than the first rows, so a global bf16 limit would let a dropped
# or mis-weighted KV tile there pass.
FLASH_REL = {torch.float32: 0.0, torch.bfloat16: 2**-7}


def _close_flash(got, want, dtype):
    got, want = got.float(), want.float()
    allowed = FLASH_REL[dtype] * want.abs() + 1e-5 * want.abs().max()
    excess = ((got - want).abs() - allowed).max().item()
    assert excess <= 0.0, excess


def _qkv(b, h, s, hd, dtype, device, seed=0, kv_heads=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, hd)] + 2 * [(b, kv_heads or h, s, hd)]
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device, dtype) for shape in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [None, (32, 8), (4, 1)])   # (H, H_kv): GQA in place
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 96, 4096])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 128, 4100])   # around the 64-key tiles
@pytest.mark.parametrize("hd", [64, 80, 120, 128])
def test_flash_attention_matches_plain(cuda, hd, s, window, dtype, heads):
    from repro_torch.kernels import flash_attention as fa

    b, h = (2, 3) if s <= 128 else (1, 2)
    if heads is not None:
        b, h = 1, heads[0]
    kv_heads = heads[1] if heads is not None else None
    q, k, v = _qkv(b, h, s, hd, dtype, cuda, seed=hd + s, kv_heads=kv_heads)
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _close_flash(got, fa.flash_attention_ref(q, k, v, window=window), dtype)
    if heads is not None:   # the same as the heads repeated by hand
        rep = [t.repeat_interleave(h // kv_heads, dim=1) for t in (k, v)]
        assert torch.equal(got, fa.flash_attention(q, *rep, window=window))


def _p_precision_case(device, s=2048, hd=120, seed=5):
    """bf16 q, k with logits of standard deviation 3 (p far from uniform)
    and V of +-(500..1500) on alternate keys, so that many outputs are a
    small difference of large terms: rounding p to bf16 before P V moves
    them by far more than the tolerance; p at f32 precision does not.
    ``test_torch_flash_attention.py`` shows both on the CPU."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(3**0.5 * rng.standard_normal((1, 2, s, hd)).astype(np.float32))
            for _ in range(2))
    sign = torch.where(torch.arange(s) % 2 == 0, 1.0, -1.0)[:, None]
    mag = torch.from_numpy(rng.uniform(500, 1500, (1, 2, 1, hd)).astype(np.float32))
    v = sign * mag
    return [t.to(device, torch.bfloat16) for t in (q, k, v)]


@pytest.mark.cuda
def test_flash_attention_bf16_keeps_p_precise(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _p_precision_case(cuda)
    got = fa.flash_attention_cuda(q, k, v)
    _close_flash(got, fa.flash_attention_ref(q, k, v), torch.bfloat16)


@pytest.mark.cuda
def test_flash_attention_bit_identical_across_launches(cuda):
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        for kv_heads in (4, 2):
            q, k, v = _qkv(1, 4, 1000, 120, dtype, cuda, seed=3, kv_heads=kv_heads)
            first = fa.flash_attention_cuda(q, k, v, window=300)
            second = fa.flash_attention_cuda(q, k, v, window=300)
            assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_attention_rejects_what_kernel_cannot_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(1, 2, 8, 16, torch.float32, cuda)
    big = torch.zeros((1, 2, 8, 129), device=cuda)
    with pytest.raises(ValueError, match="hd <= 128"):
        fa.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(TypeError, match="one\\s+dtype"):
        fa.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_cuda(q, k, v, window=0)
    three = torch.zeros((1, 3, 8, 16), device=cuda)   # 2 query heads over 3 KV heads
    with pytest.raises(ValueError, match="H % H_kv == 0"):
        fa.flash_attention_cuda(q, three, three)
    with pytest.raises(ValueError, match="H % H_kv == 0"):
        fa.flash_attention_cuda(q, k, v[:, :1])
    for hd, dtype in ((33, torch.float32), (100, torch.bfloat16)):  # rows off 16 bytes
        odd = torch.zeros((1, 2, 8, hd), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_cuda(odd, odd, odd)
    buf = torch.zeros(q.numel() + 1, device=cuda)
    shifted = buf[1:].view(q.shape)             # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_cuda(shifted, k, v)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 128, 200])
def test_transformer_forward_on_card_launches_kernel_per_layer(cuda, s):
    """A reduced H2O-Danube3-4B (GQA, window 64) forward on the card: one
    kernel launch per layer at every S, and the same logits as the plain
    chunked route and as the CPU (``test_kernel_integration.py``'s 5e-3;
    both f32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), num_kv_heads=2,
                              use_pallas_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, 512, (2, s))).to(cuda)
    before = fa.launch_count()
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert fa.launch_count() == before + cfg.num_layers
        plain, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=False)).forward(
            params, {"tokens": toks})
        cpu, _ = model.forward(_tree_to(params, "cpu"), {"tokens": toks.cpu()})
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), atol=5e-3)


@pytest.mark.cuda
def test_prefill_and_decode_step_never_wait_for_the_card(cuda):
    """No host synchronisation inside prefill or a decode step (a device
    tensor built from a host value, ``.item()``, a pageable copy): the host
    can enqueue the next step while the card runs this one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), num_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 80))).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks}, max_len=84)
            for t in range(3):
                _, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]}, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cache.index.tolist() == [83] * cfg.num_layers


# ---------------------------------------------------------------------------
# ssm_scan
# ---------------------------------------------------------------------------

# Tolerance, per element: |kernel - plain| <= rel |plain| + eps y_abs, where
# y_abs (and h_abs) is the plain scan of |x|, |B|, |C|: the sum of the
# magnitudes of every term that forms the element.  eps = 2**-20 max|la|
# + (chunk + ds) 2**-24.  The first term: the two versions form the
# in-chunk cumulative sum la in other orders, and a term's decay
# exp(la_t - la_s) takes the difference's rounding as a relative error;
# 2**-20 max|la| is 8 ulps of the largest |la| (``chip_smoke.py`` prints
# the gap it meets, about one ulp).  The second: an f32 sum of chunk + ds terms in another
# order.  bf16 adds rel = 2**-7: both round one f32 result to bf16.
SSM_REL = {torch.float32: 0.0, torch.bfloat16: 2**-7}


def _ssm_inputs(b, s, h, dh, ds, dtype, device, seed=0, valid=None):
    """The model's distributions: x, B, C ~ N(0, 1), dt = softplus(N(0, 1)
    - 2), a = -linspace(1, 16, H) (its init); steps past ``valid`` are the
    caller's padding (zeros, dt = 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)) - 2.0, 0.0).astype(np.float32)
    bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    if valid is not None:
        for t in (x, dt, bm, cm):
            t[:, valid:] = 0.0
    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(dt).to(device),
            torch.from_numpy(a).to(device), torch.from_numpy(bm).to(device, dtype),
            torch.from_numpy(cm).to(device, dtype))


def _close_ssm(got, want, inputs, chunk):
    from repro_torch.kernels import ssm_scan as ss

    x, dt, a, bm, cm = inputs
    b, s, h, _ = x.shape
    y_abs, h_abs = ss.ssm_scan_ref(x.abs().float(), dt, a, bm.abs().float(), cm.abs().float(),
                                   chunk=chunk)
    la_max = (a * dt).reshape(b, s // chunk, chunk, h).sum(2).abs().max().item()
    eps = 2**-20 * la_max + (chunk + bm.shape[-1]) * 2**-24
    (gy, gh), (wy, wh) = got, want
    gy, wy = gy.float(), wy.float()
    assert ((gy - wy).abs() - SSM_REL[x.dtype] * wy.abs() - eps * y_abs).max().item() <= 0.0
    assert ((gh - wh).abs() - eps * h_abs).max().item() <= 0.0


# (B, S, H, dh, ds, chunk, valid): Zamba2-2.7B's head (dh 160, ds 64, chunk
# 256) at a short S and a padded one (4100 -> 4352), the reduced configs'
# (dh 128, ds 16, chunk 16) and the integration test's chunk 64, an odd
# dh, a chunk of 48 and one step.
SSM_SHAPES = [(1, 512, 4, 160, 64, 256, None), (1, 4352, 2, 160, 64, 256, 4100),
              (2, 96, 4, 128, 16, 16, None), (2, 256, 3, 64, 16, 64, None),
              (2, 128, 3, 33, 64, 32, None), (1, 192, 2, 80, 64, 48, None),
              (1, 16, 1, 1, 1, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dh,ds,chunk,valid", SSM_SHAPES)
def test_ssm_scan_matches_plain(cuda, b, s, h, dh, ds, chunk, valid, dtype):
    from repro_torch.kernels import ssm_scan as ss

    inputs = _ssm_inputs(b, s, h, dh, ds, dtype, cuda, seed=dh + s, valid=valid)
    before = ss.launch_count()
    y, hf = ss.ssm_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.launch_count() == before + 1
    assert y.shape == (b, s, h, dh) and y.dtype == dtype
    assert hf.shape == (b, h, dh, ds) and hf.dtype == torch.float32
    _close_ssm((y, hf), ss.ssm_scan_ref(*inputs, chunk=chunk), inputs, chunk)
    if valid is not None:
        assert not y[:, valid:].any()


@pytest.mark.cuda
def test_ssm_scan_bit_identical_across_launches(cuda):
    from repro_torch.kernels import ssm_scan as ss

    for dtype in (torch.float32, torch.bfloat16):
        inputs = _ssm_inputs(2, 1024, 3, 160, 64, dtype, cuda, seed=5)
        (y1, h1), (y2, h2) = ss.ssm_scan_cuda(*inputs), ss.ssm_scan_cuda(*inputs)
        assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.cuda
def test_ssm_scan_rejects_what_kernel_cannot_take(cuda):
    from repro_torch.kernels import ssm_scan as ss

    x, dt, a, bm, cm = _ssm_inputs(1, 64, 2, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.ssm_scan_cuda(x, dt.cpu(), a, bm, cm, chunk=16)
    with pytest.raises(TypeError, match="one dtype"):
        ss.ssm_scan_cuda(x, dt, a, bm.to(torch.bfloat16), cm, chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ss.ssm_scan_cuda(x.half(), dt, a, bm.half(), cm.half(), chunk=16)
    with pytest.raises(TypeError, match="dt and a in float32"):
        ss.ssm_scan_cuda(x, dt.to(torch.bfloat16), a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ss.ssm_scan_cuda(x, dt, a, bm, cm, chunk=48)
    for chunk in (8, 24, 272):
        with pytest.raises(ValueError, match="multiple of 16"):
            ss.ssm_scan_cuda(x, dt, a, bm, cm, chunk=chunk)
    wide = torch.zeros((1, 64, 65), device=cuda)
    with pytest.raises(ValueError, match="ds <= 64"):
        ss.ssm_scan_cuda(x, dt, a, wide, wide, chunk=16)
    with pytest.raises(ValueError, match=r"dt \(B, S, H\)"):
        ss.ssm_scan_cuda(x, dt[:, :32], a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm, chunk=16)
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.ssm_scan(x.cpu(), dt, a, bm, cm, chunk=16)   # mixed devices reach the kernel


def _hybrid(cuda, **over):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("zamba2_2_7b").reduced(layers=12), **over)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 128])
def test_hybrid_forward_on_card_launches_both_kernels_per_layer(cuda, s):
    """A reduced Zamba2 (12 layers, two periods) forward on the card: one
    ssm_scan launch per Mamba layer and one flash_attention launch per
    shared-attention call, and the logits of the plain route and of the
    CPU within 2e-3 x max|logits| (``test_torch_hybrid.py``'s whole-model
    bar: this random-weight model turns one ulp of noise into 1.6e-4)."""
    import dataclasses

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import build_model

    cfg, model, params = _hybrid(cuda, use_pallas_kernels=True)
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, 512, (2, s))).to(cuda)
    before = (ss.launch_count(), fa.launch_count())
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert (ss.launch_count(), fa.launch_count()) == (before[0] + 12, before[1] + 2)
        plain, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=False)).forward(
            params, {"tokens": toks})
        cpu, _ = model.forward(_tree_to(params, "cpu"), {"tokens": toks.cpu()})
    _close_scaled(got, plain, 2e-3)
    _close_scaled(got.cpu(), cpu, 2e-3)


@pytest.mark.cuda
def test_hybrid_prefill_and_decode_never_wait_for_the_card(cuda):
    """As the dense model: no host synchronisation inside the hybrid's
    prefill or decode step, with the ring of the shared attention wrapping."""
    cfg, model, params = _hybrid(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 80))).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks}, max_len=84)
            for t in range(3):
                _, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]}, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cache.attn.index.tolist() == [83, 83]


# ---------------------------------------------------------------------------
# mlstm_scan
# ---------------------------------------------------------------------------

# Tolerance, per element: |kernel - plain| <= rel |plain| + eps (num_abs +
# |plain| (den_abs + D)) / D for y, where num_abs and den_abs are the plain
# numerator and denominator on |q|, |k|, |v| (the magnitudes of every term
# that forms them) and D = max(|den|, e^{-m_t}), the plain floored
# denominator; eps times the plain state of |k|, |v| for C and n, and eps
# (max|F| + |m|) for m.  eps = 2**-20 max|F| + (2 chunk + dk) 2**-24: 16
# ulps of the largest in-chunk cumulative sum F of logsigmoid(f_pre),
# which the two versions form in other orders and each weight e^{F_t - F_s
# + i_s - m_t} takes as a relative error, plus an f32 sum of up to 2 chunk
# + dk terms in another order.  bf16 adds rel = 2**-7: both round one f32
# result to bf16.  (``chip_smoke.py`` derives the same bar.)
MLSTM_REL = {torch.float32: 0.0, torch.bfloat16: 2**-7}


def _mlstm_inputs(b, s, h, dk, dv, dtype, device, seed=0, valid=None):
    """The model's distributions: q, k, v ~ N(0, 1), i_pre ~ N(0, 1), f_pre
    ~ N(3, 1); steps past ``valid`` are the model's padding (q, k, v = 0,
    i_pre = -1e9, f_pre = +1e9)."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    i_pre = rng.standard_normal((b, s, h)).astype(np.float32)
    f_pre = (rng.standard_normal((b, s, h)) + 3.0).astype(np.float32)
    if valid is not None:
        for t in (q, k, v):
            t[:, valid:] = 0.0
        i_pre[:, valid:] = -1e9
        f_pre[:, valid:] = 1e9
    return (tuple(torch.from_numpy(t).to(device, dtype) for t in (q, k, v))
            + (torch.from_numpy(i_pre).to(device), torch.from_numpy(f_pre).to(device)))


def _close_mlstm(got, want, inputs, chunk):
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
    eps = 2**-20 * f_max + (2 * chunk + dk) * 2**-24
    (gy, (gc, gn, gm)), (wy, (wc, wn, wm)) = got, want
    gy, wy = gy.float(), wy.float()
    terms_y = num_a / d[..., None] + wy.abs() * ((den_a + d) / d)[..., None]
    assert ((gy - wy).abs() - MLSTM_REL[q.dtype] * wy.abs() - eps * terms_y).max().item() <= 0.0
    assert ((gc - wc).abs() - eps * st_a.c).max().item() <= 0.0
    assert ((gn - wn).abs() - eps * st_a.n).max().item() <= 0.0
    assert ((gm - wm).abs() - eps * (f_max + wm.abs())).max().item() <= 0.0


# (B, S, H, dk, dv, chunk, valid): xLSTM-350M's head (dk = dv = 256, chunk
# 256) at a short S and a padded one (4100 -> 4352), the reduced config's
# (64, chunk 16), dk != dv both ways, odd sizes at chunk 48 and one step.
MLSTM_SHAPES = [(1, 512, 2, 256, 256, 256, None), (1, 4352, 1, 256, 256, 256, 4100),
                (2, 96, 4, 64, 64, 16, 90), (2, 256, 3, 64, 128, 64, None),
                (1, 192, 2, 128, 32, 64, None), (2, 144, 3, 33, 70, 48, None),
                (1, 16, 1, 1, 1, 16, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dk,dv,chunk,valid", MLSTM_SHAPES)
def test_mlstm_scan_matches_plain(cuda, b, s, h, dk, dv, chunk, valid, dtype):
    from repro_torch.kernels import mlstm_scan as ms

    inputs = _mlstm_inputs(b, s, h, dk, dv, dtype, cuda, seed=dk + s, valid=valid)
    before = ms.launch_count()
    y, (c, n, m) = ms.mlstm_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ms.launch_count() == before + 1
    assert y.shape == (b, s, h, dv) and y.dtype == dtype
    assert (c.shape, n.shape, m.shape) == ((b, h, dk, dv), (b, h, dk), (b, h))
    _close_mlstm((y, (c, n, m)), ms.mlstm_scan_ref(*inputs, chunk=chunk), inputs, chunk)
    if valid is not None:
        assert not y[:, valid:].any()


@pytest.mark.cuda
def test_mlstm_scan_bit_identical_across_launches(cuda):
    from repro_torch.kernels import mlstm_scan as ms

    for dtype in (torch.float32, torch.bfloat16):
        inputs = _mlstm_inputs(2, 1024, 3, 256, 256, dtype, cuda, seed=5)
        (y1, st1), (y2, st2) = ms.mlstm_scan_cuda(*inputs), ms.mlstm_scan_cuda(*inputs)
        assert torch.equal(y1, y2) and all(torch.equal(a, b) for a, b in zip(st1, st2))


@pytest.mark.cuda
def test_mlstm_scan_rejects_what_kernel_cannot_take(cuda):
    from repro_torch.kernels import mlstm_scan as ms

    q, k, v, i_pre, f_pre = _mlstm_inputs(1, 64, 2, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.mlstm_scan_cuda(q, k, v, i_pre.cpu(), f_pre, chunk=16)
    with pytest.raises(TypeError, match="one dtype"):
        ms.mlstm_scan_cuda(q, k.to(torch.bfloat16), v, i_pre, f_pre, chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ms.mlstm_scan_cuda(q.half(), k.half(), v.half(), i_pre, f_pre, chunk=16)
    with pytest.raises(TypeError, match="i_pre and f_pre in float32"):
        ms.mlstm_scan_cuda(q, k, v, i_pre, f_pre.to(torch.bfloat16), chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ms.mlstm_scan_cuda(q, k, v, i_pre, f_pre, chunk=48)
    for chunk in (8, 24, 272):
        with pytest.raises(ValueError, match="multiple of 16"):
            ms.mlstm_scan_cuda(q, k, v, i_pre, f_pre, chunk=chunk)
    wide = torch.zeros((1, 64, 2, 257), device=cuda)
    with pytest.raises(ValueError, match="dk and dv up to 256"):
        ms.mlstm_scan_cuda(wide, wide, v, i_pre, f_pre, chunk=16)
    with pytest.raises(ValueError, match="dk and dv up to 256"):
        ms.mlstm_scan_cuda(q, k, wide, i_pre, f_pre, chunk=16)
    with pytest.raises(ValueError, match=r"i_pre and f_pre \(B, S, H\)"):
        ms.mlstm_scan_cuda(q, k, v, i_pre[:, :32], f_pre, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ms.mlstm_scan_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, i_pre, f_pre,
                           chunk=16)
    with pytest.raises(ValueError, match="one CUDA device"):
        ms.mlstm_scan(q.cpu(), k, v, i_pre, f_pre, chunk=16)   # mixed devices reach the kernel


def _xlstm(cuda, **over):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("xlstm_350m").reduced(layers=12), **over)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator(device=cuda).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 128])
def test_xlstm_forward_on_card_launches_kernel_per_mlstm_layer(cuda, s):
    """A reduced xLSTM (12 layers, two periods) forward on the card: one
    mlstm_scan launch per mLSTM layer, and the logits of the plain route and
    of the CPU within 2e-3 x max|logits| (``test_torch_xlstm.py``'s
    whole-model bar: this random-weight model turns one ulp of noise into
    2.5e-4)."""
    import dataclasses

    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.models import build_model

    cfg, model, params = _xlstm(cuda, use_pallas_kernels=True)
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, 512, (2, s))).to(cuda)
    before = ms.launch_count()
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert ms.launch_count() == before + 10
        plain, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=False)).forward(
            params, {"tokens": toks})
        cpu, _ = model.forward(_tree_to(params, "cpu"), {"tokens": toks.cpu()})
    _close_scaled(got, plain, 2e-3)
    _close_scaled(got.cpu(), cpu, 2e-3)


@pytest.mark.cuda
def test_xlstm_prefill_and_decode_never_wait_for_the_card(cuda):
    """As the dense model: no host synchronisation inside xLSTM's prefill
    or decode step (the sLSTM loop included)."""
    cfg, model, params = _xlstm(cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 80))).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks}, max_len=84)
            for t in range(3):
                _, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]}, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(cache.mlstm.c).all()) and bool(torch.isfinite(cache.slstm.h).all())
