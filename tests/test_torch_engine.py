"""repro_torch.core.engine.fused_layer_step against repro's, on the same
numpy inputs, for a propagated layer (W given) and the l = 0 step.

The reference runs with ``use_kernels`` both True (the Pallas
``propagate_gram``/``gram`` kernels in interpret mode on these 128-aligned
shapes) and False (its einsum path); the port always goes through its
ops, which take the plain versions on the CPU.

Tolerances: Y' rtol/atol 1e-5 (f32 sums of n_prev = 128 products in two
orders).  The readouts run K = 20 ADMM iterations from Grams that differ
by f32 rounding: o_star, o_workers and lam within a relative Frobenius
gap of 1e-4, the objective trace at rtol 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.backend import SimulatedBackend as JBackend
from repro_torch.core import engine, layerwise, ssfn
from repro_torch.core.backend import SimulatedBackend

M, Q, N_PREV, N, JM, K = 4, 4, 128, 256, 256, 20
KW = dict(mu=1e-1, eps_radius=8.0, num_iters=K)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    yw = np.abs(rng.standard_normal((M, N_PREV, JM))).astype(np.float32)
    labels = rng.integers(0, Q, (M, JM))
    tw = np.eye(Q, dtype=np.float32)[labels].transpose(0, 2, 1).copy()
    w = (rng.standard_normal((N, N_PREV)) / np.sqrt(N_PREV)).astype(np.float32)
    return yw, tw, w


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _check(got, want):
    assert _rel(got.o_star.numpy(), want.o_star) <= 1e-4
    assert _rel(got.o_workers.numpy(), want.o_workers) <= 1e-4
    assert _rel(got.lam.numpy(), want.lam) <= 1e-4
    assert got.jitter.tolist() == np.asarray(want.jitter).tolist()
    w_obj = np.asarray(want.trace.objective)
    assert got.trace.objective.shape == w_obj.shape == (K,)
    np.testing.assert_allclose(got.trace.objective.numpy(), w_obj, rtol=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_propagated_step_matches_reference(use_kernels):
    yw, tw, w = _inputs()
    want = jengine.fused_layer_step(
        JBackend(M), jnp.asarray(yw), jnp.asarray(tw), jnp.asarray(w),
        use_kernels=use_kernels, **KW,
    )
    got = engine.fused_layer_step(
        SimulatedBackend(M), torch.from_numpy(yw), torch.from_numpy(tw),
        torch.from_numpy(w), **KW,
    )
    assert got.y_workers.shape == (M, N, JM)
    np.testing.assert_allclose(got.y_workers.numpy(), np.asarray(want.y_workers),
                               rtol=1e-5, atol=1e-5)
    _check(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_layer0_step_matches_reference(use_kernels):
    yw, tw, _ = _inputs(seed=1)
    want = jengine.fused_layer_step(
        JBackend(M), jnp.asarray(yw), jnp.asarray(tw), None, use_kernels=use_kernels, **KW
    )
    got = engine.fused_layer_step(
        SimulatedBackend(M), torch.from_numpy(yw), torch.from_numpy(tw), None, **KW
    )
    assert np.array_equal(got.y_workers.numpy(), yw)
    _check(got, want)


def test_untraced_step_has_the_same_iterates():
    yw, tw, w = _inputs(seed=2)
    args = (torch.from_numpy(yw), torch.from_numpy(tw), torch.from_numpy(w))
    traced = engine.fused_layer_step(SimulatedBackend(M), *args, **KW)
    hot = engine.fused_layer_step(SimulatedBackend(M), *args, trace_every=0, **KW)
    assert hot.trace is None
    assert torch.equal(hot.o_star, traced.o_star) and torch.equal(hot.lam, traced.lam)


def test_worker_count_mismatch_raises():
    yw, tw, w = _inputs()
    with pytest.raises(ValueError, match="worker shards"):
        engine.fused_layer_step(SimulatedBackend(M + 1), torch.from_numpy(yw),
                                torch.from_numpy(tw), torch.from_numpy(w), **KW)


def _train_problem(m, p, q, jm, num_layers, hidden, admm_iters, seed):
    rng = np.random.default_rng(seed)
    cfg = ssfn.SSFNConfig(input_dim=p, num_classes=q, num_layers=num_layers,
                          hidden=hidden, admm_iters=admm_iters)
    xw = torch.from_numpy(rng.standard_normal((m, p, jm)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, q, (m, jm)))
    tw = torch.nn.functional.one_hot(labels, q).permute(0, 2, 1).float()
    return cfg, xw, tw


def test_train_records_one_program_per_distinct_layer_shape():
    """The counterpart of repro's compile-count test: L=3 is four layer
    solves but three distinct programs (l=0 without W, l=1 with W n x P,
    l=2..3 with W n x n); the fourth solve reuses the third's."""
    backend = SimulatedBackend(1)
    cfg, xw, tw = _train_problem(1, 8, 3, 24, 3, 20, 10, seed=3)
    gen = torch.Generator().manual_seed(0)
    params, _ = layerwise.train_decentralized_ssfn(xw, tw, cfg, gen, backend=backend)
    assert len(params.o) == 4
    assert backend.lowerings == 3 and backend.cache_hits == 1, backend.cache_info()
    # A second identical train through the same backend adds no program.
    layerwise.train_decentralized_ssfn(
        xw, tw, cfg, torch.Generator().manual_seed(0), backend=backend
    )
    assert backend.lowerings == 3 and backend.cache_info()["entries"] == 3
