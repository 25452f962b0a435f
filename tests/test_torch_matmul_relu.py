"""repro_torch's matmul_relu: its plain version against repro's Pallas
kernel (interpret mode) and oracle, its dispatch rule and its build
machinery.  The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, on a card.

Tolerances: f32 rtol/atol 1e-5 (both sides sum in f32, in different
orders).  bf16 outputs: both sides round the f32 sum to bf16, so a sum
that the two orders leave on either side of a rounding boundary differs
by one bf16 ulp, 2**-7 relative.
"""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.matmul_relu import matmul_relu_ref as jref
from repro.kernels.matmul_relu.kernel import matmul_relu_pallas
from repro_torch.kernels import _build
from repro_torch.kernels.matmul_relu import (
    launch_count,
    matmul_relu,
    matmul_relu_ref,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    return w, x


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 256), (128, 384, 128)])
def test_plain_matches_pallas_interpret_on_aligned_shapes(m, k, n):
    w, x = _operands(m, k, n)
    want = np.asarray(matmul_relu_pallas(jnp.asarray(w), jnp.asarray(x), interpret=True))
    got = matmul_relu(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "m,k,n", [(20, 8, 5), (1020, 784, 1), (1020, 1020, 8), (120, 300, 77), (1, 1, 1)]
)
def test_plain_matches_reference_oracle_on_ragged_shapes(m, k, n):
    w, x = _operands(m, k, n, seed=m + k + n)
    want = np.asarray(jref(jnp.asarray(w), jnp.asarray(x)))
    got = matmul_relu_ref(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_bf16_matches_reference_oracle():
    w, x = _operands(64, 96, 24, seed=5)
    w16, x16 = w.astype(ml_dtypes.bfloat16), x.astype(ml_dtypes.bfloat16)
    want = np.asarray(jref(jnp.asarray(w16), jnp.asarray(x16))).astype(np.float32)
    got = matmul_relu_ref(
        torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_relu_keeps_nan_like_reference():
    w = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    x = torch.tensor([[float("nan")], [1.0]])
    out = matmul_relu(w, x)
    assert torch.isnan(out).all()


def test_cpu_tensors_take_plain_version():
    w, x = _operands(20, 8, 5)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    before = launch_count()
    assert torch.equal(matmul_relu(tw, tx), matmul_relu_ref(tw, tx))
    assert launch_count() == before


@pytest.mark.parametrize("wdev,xdev", [("meta", "meta"), ("cpu", "meta"), ("meta", "cpu")])
def test_non_cpu_tensors_go_to_kernel_and_raise_without_fallback(wdev, xdev):
    """Anything not wholly on the CPU reaches the CUDA wrapper, which
    raises for what it cannot take — there is no quiet plain fallback."""
    w = torch.zeros((4, 3), device=wdev)
    x = torch.zeros((3, 2), device=xdev)
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_relu(w, x)


# ---------------------------------------------------------------------------
# Build machinery (no nvcc here)
# ---------------------------------------------------------------------------


def test_kernel_modules_import_without_nvcc(tmp_path):
    """Importing the wrapper and builder with no nvcc anywhere compiles
    nothing and does not fail."""
    env = dict(os.environ, PYTHONPATH=SRC, PATH=str(tmp_path),
               CUDA_HOME=str(tmp_path / "no-cuda"))
    code = (
        "import repro_torch.kernels._build as b, "
        "repro_torch.kernels.matmul_relu.kernel as k, "
        "repro_torch.kernels.gram.kernel as g, "
        "repro_torch.kernels.propagate_gram.kernel as p, "
        "repro_torch.kernels.flash_attention.kernel as f, "
        "repro_torch.kernels.ssm_scan.kernel as s, "
        "repro_torch.kernels.mlstm_scan.kernel as m; "
        "print(b.kernel_names(), k.launch_count(), g.launch_count(), p.launch_count(), "
        "f.launch_count(), s.launch_count(), m.launch_count())"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "['flash_attention', 'gram', 'matmul_relu', 'mlstm_scan', 'propagate_gram', 'ssm_scan'] "
        "0 0 0 0 0 0")


def test_build_without_nvcc_raises_and_builds_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert list((tmp_path / "build").iterdir()) == []


def test_library_path_is_keyed_by_source_hash(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.library_path("matmul_relu")
    assert before.parent == tmp_path / "build"
    assert before.name.startswith("libmatmul_relu-") and before.suffix == ".so"
    with open(csrc / "matmul_relu.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("matmul_relu") != before


def test_nvcc_flags_target_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
