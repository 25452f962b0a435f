"""repro_torch.core.admm against repro.core.admm on the same numpy inputs.

- ``guarded_cholesky`` reaches the reference's jitter level on clear
  cases (healthy 0, all-zero 1, NaN ``max_tries`` with a NaN factor).
- ``project_frobenius`` and the consensus ADMM solve match, and the
  solve reaches the exact constrained-ridge oracle (rel < 1e-4, as
  ``tests/test_admm.py`` holds the reference).

Tolerances: the ADMM solves run K = 300 f32 iterations in two
frameworks whose GEMMs and reductions sum in different orders; the
iterates drift apart by a few f32 ulps per iteration, well inside the
relative gap of 1e-4 on ``o_star`` and rtol 1e-4 on the traces.  A
Cholesky factor of a well-conditioned 16 x 16 matrix agrees to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as jadmm
from repro.core.backend import SimulatedBackend as JBackend
from repro_torch.core import admm
from repro_torch.core.backend import SimulatedBackend
from repro_torch.core.policy import ExactMean


def _problem(n, q, j, m, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, j)).astype(np.float32)
    t = rng.standard_normal((q, j)).astype(np.float32)
    yw = np.ascontiguousarray(y.reshape(n, m, j // m).transpose(1, 0, 2))
    tw = np.ascontiguousarray(t.reshape(q, m, j // m).transpose(1, 0, 2))
    return y, t, yw, tw


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_guarded_cholesky_levels_match_reference():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    spd = a @ a.T + 16 * np.eye(16, dtype=np.float32)
    zero = np.zeros((16, 16), np.float32)
    nan = np.full((16, 16), np.nan, np.float32)
    g = np.stack([spd, zero, nan])
    j_chol, j_level = jax.vmap(jadmm.guarded_cholesky)(jnp.asarray(g))
    chol, level = admm.guarded_cholesky(torch.from_numpy(g))
    assert level.dtype == torch.int32
    assert level.tolist() == np.asarray(j_level).tolist() == [0, 1, 6]
    np.testing.assert_allclose(chol[0].numpy(), np.asarray(j_chol[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chol[1].numpy(), np.asarray(j_chol[1]), rtol=1e-5, atol=1e-12)
    assert not torch.isfinite(chol[2]).all() and not np.isfinite(np.asarray(j_chol[2])).all()
    # Unbatched input, level shape follows.
    c, lv = admm.guarded_cholesky(torch.from_numpy(spd))
    assert lv.shape == () and int(lv) == 0 and torch.allclose(c, chol[0])


def test_project_frobenius_matches_reference_per_worker():
    rng = np.random.default_rng(2)
    z = rng.standard_normal((3, 4, 5)).astype(np.float32)
    z[1] *= 0.01                                  # inside the ball: untouched
    got = admm.project_frobenius(torch.from_numpy(z), 2.0).numpy()
    for i in range(3):
        want = np.asarray(jadmm.project_frobenius(jnp.asarray(z[i]), 2.0))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(got[1], z[1])
    assert np.linalg.norm(got[0]) == pytest.approx(2.0, rel=1e-6)


def test_decentralized_matches_exact_oracle():
    y, t, yw, tw = _problem(32, 5, 400, 4)
    oracle = admm.exact_constrained_ridge(torch.from_numpy(y), torch.from_numpy(t), eps_radius=10.0)
    assert oracle.dtype == torch.float64
    res = admm.admm_ridge_consensus(
        torch.from_numpy(yw), torch.from_numpy(tw), mu=1e-2, eps_radius=10.0, num_iters=300
    )
    assert _rel(res.o_star.numpy(), oracle.numpy()) < 1e-4


@pytest.mark.parametrize("trace_every", [0, 1, 5])
def test_consensus_solve_matches_reference(trace_every):
    _, _, yw, tw = _problem(32, 5, 400, 4, seed=3)
    kw = dict(mu=1e-2, eps_radius=10.0, num_iters=300, trace_every=trace_every)
    want = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(4), **kw)
    got = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw), **kw)
    assert _rel(got.o_star.numpy(), want.o_star) <= 1e-4
    assert _rel(got.o_workers.numpy(), want.o_workers) <= 1e-4
    assert got.jitter.tolist() == np.asarray(want.jitter).tolist() == [0, 0, 0, 0]
    if trace_every == 0:
        assert got.trace is None and want.trace is None
        return
    for field in ("objective", "primal_residual", "dual_residual"):
        g, w = getattr(got.trace, field).numpy(), np.asarray(getattr(want.trace, field))
        assert g.shape == w.shape == (300 // trace_every,)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    assert not got.trace.consensus_error.any()


def test_projection_keeps_iterates_feasible():
    _, _, yw, tw = _problem(16, 3, 160, 4, seed=4)
    res = admm.admm_ridge_consensus(
        torch.from_numpy(yw), torch.from_numpy(tw), mu=1e-1, eps_radius=0.5, num_iters=50
    )
    assert float(torch.linalg.vector_norm(res.o_star)) <= 0.5 * (1 + 1e-5)


def test_centralized_equals_decentralized_at_convergence():
    y, t, yw, tw = _problem(24, 4, 240, 6, seed=5)
    kw = dict(mu=1e-2, eps_radius=8.0, num_iters=400)
    cen = admm.centralized_ridge_admm(torch.from_numpy(y), torch.from_numpy(t), **kw)
    dec = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw), **kw)
    assert _rel(dec.o_star.numpy(), cen.o_star.numpy()) < 1e-4


def test_repeated_solves_record_one_program():
    """The counterpart of repro's compile-count test: same shapes and
    hyper-parameters through one backend are one program."""
    _, _, yw, tw = _problem(16, 3, 160, 4, seed=6)
    backend = SimulatedBackend(4)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=20, backend=backend)
    a = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw), **kw)
    b = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw), **kw)
    info = backend.cache_info()
    assert info["lowerings"] == info["entries"] == 1 and info["cache_hits"] == 1
    assert torch.equal(a.o_star, b.o_star)
    admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                              mu=1e-1, eps_radius=6.0, num_iters=20, backend=backend)
    assert backend.lowerings == 2


def test_unported_and_invalid_arguments_raise():
    _, _, yw, tw = _problem(8, 2, 40, 2, seed=7)
    y, t = torch.from_numpy(yw), torch.from_numpy(tw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        admm.admm_ridge_consensus(y, t, mu=1.0, eps_radius=1.0, num_iters=2,
                                  consensus_fn=lambda v: v)
    with pytest.raises(ValueError, match="must divide"):
        admm.admm_ridge_consensus(y, t, mu=1.0, eps_radius=1.0, num_iters=5, trace_every=2)
    with pytest.raises(ValueError, match=">= 0"):
        admm.validate_trace_every(-1, 4)
    with pytest.raises(ValueError, match="worker shards"):
        admm.admm_ridge_consensus(y, t, mu=1.0, eps_radius=1.0, num_iters=2,
                                  backend=SimulatedBackend(3))

    class EveryOther(ExactMean):
        @property
        def communication_interval(self):
            return 2

    with pytest.raises(NotImplementedError, match="communication_interval"):
        admm.admm_ridge_consensus(y, t, mu=1.0, eps_radius=1.0, num_iters=4,
                                  policy=EveryOther())
    with pytest.raises(ValueError, match="must divide"):
        admm.admm_ridge_consensus(y, t, mu=1.0, eps_radius=1.0, num_iters=3,
                                  policy=EveryOther())


def test_exact_mean_and_simulated_backend_collectives():
    from repro.core.policy import ExactMean as JExactMean

    policy, ref = ExactMean(), JExactMean()
    for kw in (dict(scalars=40, num_consensus=100, num_workers=20),
               dict(scalars=7, num_consensus=3)):
        assert policy.comm_scalars(**kw) == ref.comm_scalars(**kw)
        assert policy.wire_bytes(**kw) == ref.wire_bytes(**kw)
    assert policy.is_exact and policy.exchanges_for(8) == 1
    assert policy.mode_name == ref.mode_name == "exact"
    backend = SimulatedBackend(3)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(backend.consensus_mean(x), torch.tensor([[2.0, 3.0]] * 3))
    assert torch.equal(backend.psum(x), torch.tensor([[6.0, 9.0]] * 3))
    assert torch.equal(backend.pmax(x), torch.tensor([[4.0, 5.0]] * 3))
    assert backend.ctx().worker_index().tolist() == [0, 1, 2]
    assert backend.describe() == "SimulatedBackend(M=3, policy=ExactMean())"
    with pytest.raises(TypeError, match="ConsensusPolicy"):
        SimulatedBackend(2, policy="exact")
    with pytest.raises(ValueError, match=">= 1"):
        SimulatedBackend(0)
    with pytest.raises(ValueError, match="leading dim"):
        backend.run(lambda a: a, torch.zeros(2, 4))
