"""The port's CUDA legs: they need an NVIDIA GPU and skip without one.

This file imports neither JAX nor ``repro``, so it also runs on a host
that has only the port's dependencies:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: f32 rtol/atol 1e-5 against the plain version (both sum in
f32, in different orders); bf16 one bf16 ulp, 2**-7 relative, since both
round an f32 sum to bf16 and two orders may leave it on either side of a
rounding boundary.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn
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
