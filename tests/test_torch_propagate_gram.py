"""repro_torch's propagate_gram op: its plain version against repro's
fused Pallas kernel (interpret mode, vmapped over workers with W shared)
and oracle, and its dispatch rule.  The CUDA kernels themselves are held
against the plain version in tests/test_torch_cuda.py, on a card.

Tolerances: Y' rtol/atol 1e-5 (f32 sums of n_prev <= 256 products in two
orders); G rtol 1e-5 and atol 1e-5 x max|G| (J <= 256 products of those
Y').  bf16: Y' is rounded to bf16 by both sides, so a sum the two orders
leave on either side of a rounding boundary differs by one bf16 ulp
(2**-7 relative); G is built from the f32 Y' before rounding by both the
Pallas kernel and the port, so it keeps the f32 tolerance.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.propagate_gram import propagate_gram_ref as jref
from repro.kernels.propagate_gram.kernel import propagate_gram_pallas
from repro_torch.kernels.propagate_gram import (
    launch_count,
    propagate_gram,
    propagate_gram_ref,
)

MU = 1e-1
TOL = dict(rtol=1e-5, atol=1e-5)


def _operands(n, n_prev, m, j, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, n_prev)) / np.sqrt(n_prev)).astype(np.float32)
    y = np.abs(rng.standard_normal((m, n_prev, j))).astype(np.float32)
    return w, y


def _close_g(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _pallas(w, y, **kw):
    return jax.vmap(
        lambda a: propagate_gram_pallas(jnp.asarray(w), a, mu=MU, interpret=True, **kw)
    )(jnp.asarray(y))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("j", [128, 256])
@pytest.mark.parametrize("n_prev", [128, 256])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_matches_pallas_interpret_on_aligned_shapes(n, n_prev, j, m):
    w, y = _operands(n, n_prev, m, j, seed=n + n_prev + j + m)
    want_y, want_g = _pallas(w, y)
    got_y, got_g = propagate_gram(torch.from_numpy(w), torch.from_numpy(y), mu=MU)
    assert got_y.shape == (m, n, j) and got_g.shape == (m, n, n)
    assert got_y.dtype == torch.float32 and got_g.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    _close_g(got_g.numpy(), want_g)


@pytest.mark.parametrize("n,n_prev,m,j", [(20, 13, 1, 37), (20, 13, 3, 37), (1, 1, 1, 1), (33, 257, 3, 65)])
def test_plain_matches_reference_oracle_on_ragged_shapes(n, n_prev, m, j):
    w, y = _operands(n, n_prev, m, j, seed=n * j + m)
    outs = [jref(jnp.asarray(w), jnp.asarray(y[i]), mu=MU) for i in range(m)]
    got_y, got_g = propagate_gram_ref(torch.from_numpy(w), torch.from_numpy(y), mu=MU)
    np.testing.assert_allclose(got_y.numpy(), np.stack([np.asarray(o[0]) for o in outs]), **TOL)
    _close_g(got_g.numpy(), np.stack([np.asarray(o[1]) for o in outs]))


def test_bf16_grams_the_unrounded_features_as_the_pallas_kernel_does():
    w, y = _operands(128, 128, 2, 128, seed=3)
    wb, yb = w.astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)
    want_y, want_g = _pallas(wb, yb)
    got_y, got_g = propagate_gram(
        torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(yb.astype(np.float32)).to(torch.bfloat16),
        mu=MU,
    )
    assert got_y.dtype == torch.bfloat16 and got_g.dtype == torch.float32
    np.testing.assert_allclose(
        got_y.float().numpy(), np.asarray(want_y).astype(np.float32),
        rtol=2**-7, atol=2**-7,
    )
    _close_g(got_g.numpy(), want_g)
    # repro's oracle grams the ROUNDED Y', which the tolerance tells apart.
    rounded = np.asarray(jref(jnp.asarray(wb), jnp.asarray(yb[0]), mu=MU)[1])
    assert np.abs(rounded - np.asarray(want_g[0])).max() > 1e-5 * np.abs(want_g[0]).max()


def test_cpu_takes_the_plain_version_and_other_devices_the_kernel():
    w, y = _operands(6, 5, 2, 7)
    w, y = torch.from_numpy(w), torch.from_numpy(y)
    before = launch_count()
    got = propagate_gram(w, y, mu=MU)
    want = propagate_gram_ref(w, y, mu=MU)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launch_count() == before
    with pytest.raises(ValueError, match="CUDA device"):
        propagate_gram(w.to("meta"), y.to("meta"), mu=MU)
    assert launch_count() == before
