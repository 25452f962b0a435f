"""repro_torch's gram op: its plain version against repro's Pallas kernel
(interpret mode, vmapped over workers) and oracle, its dispatch rule, and
the build's view of the shared Gram header.  The CUDA kernel itself is
held against the plain version in tests/test_torch_cuda.py, on a card.

Tolerance: rtol 1e-5 and atol 1e-5 x max|G|.  Both sides sum J <= 300
products in f32, in different orders (XLA's and PyTorch's CPU GEMMs, or
the Pallas kernel's 128-wide J blocks), a few f32 ulps of the largest
entry; bf16 inputs widen exactly to f32 in both, so they keep it.
"""
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.gram import gram_ref as jref
from repro.kernels.gram.kernel import gram_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.gram import gram, gram_ref, launch_count

MU = 1e-2


def _features(m, n, j, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n, j)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("j", [128, 256])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_matches_pallas_interpret_on_aligned_shapes(n, j, m):
    y = _features(m, n, j, seed=n + j + m)
    want = jax.vmap(lambda a: gram_pallas(a, mu=MU, interpret=True))(jnp.asarray(y))
    got = gram(torch.from_numpy(y), mu=MU)
    assert got.dtype == torch.float32 and got.shape == (m, n, n)
    _close(got.numpy(), want)


@pytest.mark.parametrize("m,n,j", [(1, 20, 37), (3, 13, 5), (2, 1, 1), (3, 100, 300)])
def test_plain_matches_reference_oracle_on_ragged_shapes(m, n, j):
    y = _features(m, n, j, seed=m * n + j)
    want = np.stack([np.asarray(jref(jnp.asarray(y[i]), mu=MU)) for i in range(m)])
    _close(gram_ref(torch.from_numpy(y), mu=MU).numpy(), want)


def test_bf16_inputs_sum_in_f32():
    y = _features(3, 20, 37).astype(ml_dtypes.bfloat16)
    want = np.stack([np.asarray(jref(jnp.asarray(y[i]), mu=MU)) for i in range(3)])
    got = gram(torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16), mu=MU)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_cpu_takes_the_plain_version_and_other_devices_the_kernel():
    y = torch.from_numpy(_features(2, 5, 7))
    before = launch_count()
    assert torch.equal(gram(y, mu=MU), gram_ref(y, mu=MU))
    assert launch_count() == before
    # Not a CPU tensor: the kernel wrapper takes it and refuses what it
    # cannot launch; nothing falls back to the plain version.
    with pytest.raises(ValueError, match="CUDA"):
        gram(torch.empty((2, 5, 7), device="meta"), mu=MU)
    assert launch_count() == before


def test_build_knows_the_new_kernels_and_hashes_the_shared_header(tmp_path, monkeypatch):
    assert {"gram", "propagate_gram", "matmul_relu"} <= set(_build.kernel_names())
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in ("gram", "propagate_gram")}
    header = csrc / "gram.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _build.library_path(name) != path
