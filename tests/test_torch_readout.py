"""The port's layer-wise readout (``core/readout.py``) against ``repro``'s on
the CPU: ports of ``tests/test_system.py:118-215`` and of
``tests/test_multidevice.py``'s 8-device ADMM test on 4 gloo ranks.

The same numpy features go through both packages.  Bars: readouts within
1e-4 x max|O| of ``repro``'s; the single-process Gram-sharing and sharded
solvers within 1e-3 of the float64 ``exact_constrained_ridge`` and 1e-4
of ``repro``'s; the 4-rank ``admm_solve_sharded`` within 1e-3 of the
oracle and 1e-5 of the simulated M=4 ``admm_ridge_consensus`` on the same
contiguous sample blocks; where consensus ADMM converges slowly (fewer
samples a worker than features), the decentralized readout is still
``repro``'s within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.core import admm as j_admm
from repro.core import readout as j_readout
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as j_build_model
from repro.nn.layers import embed_lookup as j_embed_lookup
from repro.sharding.rules import shard_map_compat
from repro_torch.core import admm, readout
from repro_torch.launch import mesh as mesh_lib

READOUT_REL = 1e-4
ORACLE_REL = 1e-3
RANKS = 4


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _problem(n, q, j, ky, kt):
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(ky), (n, j))),
            np.asarray(jax.random.normal(jax.random.PRNGKey(kt), (q, j))))


@pytest.fixture(scope="module")
def backbone():
    """``test_system.py``'s two taps of a frozen reduced StableLM-3B
    (embedding and the final hidden state's first d logits), its
    targets, and ``repro``'s fit on them."""
    cfg = j_get_config("stablelm_3b").reduced()
    model = j_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    b, s, q = 4, 16, 5
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)),
                         jnp.int32)
    emb = j_embed_lookup(params["embed"], tokens)
    logits, _ = model.forward(params, {"tokens": tokens})
    feats = [np.asarray(emb.reshape(-1, cfg.d_model).T, np.float32),
             np.asarray(logits[..., :cfg.d_model].reshape(-1, cfg.d_model).T, np.float32)]
    labels = np.random.default_rng(1).integers(0, q, (b * s,))
    targets = np.asarray(jax.nn.one_hot(jnp.asarray(labels), q).T, np.float32)
    fit = j_readout.layerwise_backbone_fit([jnp.asarray(f) for f in feats],
                                           jnp.asarray(targets), mu=1e-2, num_iters=40)
    return cfg, feats, targets, fit


def test_layerwise_backbone_readout_on_transformer(backbone):
    cfg, feats, targets, want = backbone
    fit = readout.layerwise_backbone_fit([_t(f) for f in feats], _t(targets),
                                         mu=1e-2, num_iters=40)
    q = targets.shape[0]
    assert len(fit.readouts) == 2
    assert fit.readouts[0].shape == (q, cfg.d_model)
    assert bool(torch.isfinite(fit.layer_costs).all())
    for got, w in zip(fit.readouts, want.readouts):
        w = np.asarray(w)
        assert float(np.abs(got.numpy() - w).max()) <= READOUT_REL * float(np.abs(w).max())
    np.testing.assert_allclose(fit.layer_costs.numpy(), np.asarray(want.layer_costs),
                               rtol=READOUT_REL)


def test_fit_readout_reaches_the_gram_op(backbone, monkeypatch):
    """Each tap's solve is the centralized ADMM, whose Gram is the op's."""
    _, feats, targets, _ = backbone
    calls = []
    real = admm.gram
    monkeypatch.setattr(admm, "gram", lambda y, mu: calls.append(tuple(y.shape)) or real(y, mu=mu))
    readout.layerwise_backbone_fit([_t(f) for f in feats], _t(targets), mu=1e-2, num_iters=4)
    assert calls == [(1,) + f.shape for f in feats]


def test_gram_share_solver_matches_admm():
    n, q, j = 24, 4, 96
    y, t = _problem(n, q, j, 2, 3)
    mesh = make_host_mesh(1)
    fn = shard_map_compat(
        functools.partial(j_readout.gram_share_solve_sharded, eps_radius=8.0,
                          axis_names=("data",)),
        mesh=mesh, in_specs=(P(None, "data"), P(None, "data")), out_specs=P(),
    )
    with mesh:
        want = np.asarray(jax.jit(fn)(jnp.asarray(y), jnp.asarray(t)))
    got = readout.gram_share_solve_sharded(_t(y), _t(t), eps_radius=8.0)
    oracle = admm.exact_constrained_ridge(_t(y), _t(t), eps_radius=8.0).numpy()
    res = admm.admm_ridge_consensus(_t(y)[None], _t(t)[None], mu=1e-2, eps_radius=8.0,
                                    num_iters=400)
    assert _rel(got.numpy(), oracle) < ORACLE_REL
    assert _rel(res.o_star.numpy(), oracle) < ORACLE_REL
    assert _rel(got.numpy(), want) < READOUT_REL


def test_sharded_admm_in_one_process():
    """``make_sharded_layer_solver`` with no group is one worker: the
    consensus readout and its objective trace, as ``repro``'s on a
    1-device mesh."""
    n, q, j = 16, 3, 64
    y, t = _problem(n, q, j, 0, 1)
    mesh = make_host_mesh(1)
    jsolver = j_readout.make_sharded_layer_solver(mesh, ("data",), mu=1e-2, eps_radius=6.0,
                                                  num_iters=100)
    with mesh:
        want = jax.jit(jsolver)(jnp.asarray(y), jnp.asarray(t))
    got = readout.make_sharded_layer_solver(mu=1e-2, eps_radius=6.0, num_iters=100)(_t(y), _t(t))
    oracle = admm.exact_constrained_ridge(_t(y), _t(t), eps_radius=6.0).numpy()
    assert _rel(got.z.numpy(), oracle) < ORACLE_REL
    assert _rel(got.z.numpy(), np.asarray(want.z)) < READOUT_REL
    assert got.objective.shape == (100,)
    np.testing.assert_allclose(got.objective.numpy(), np.asarray(want.objective),
                               rtol=READOUT_REL)


def _sharded_rank(group, y, t):
    solver = readout.make_sharded_layer_solver(group, mu=1e-2, eps_radius=6.0, num_iters=300)
    res = solver(torch.from_numpy(y), torch.from_numpy(t))
    return res.z.numpy(), res.objective.numpy(), dict(group.transport.stats.counts)


def test_distributed_admm_on_4_ranks():
    """``test_multidevice.py``'s n=16, q=3, J=256, K=300 solve on 4 gloo
    ranks of one worker each: every rank holds the same readout, within
    1e-3 of the oracle and 1e-5 of the simulated M=4 consensus on the same
    contiguous blocks, after one all-reduce an iteration and one for the
    objective trace."""
    n, q, j = 16, 3, 256
    y, t = (a.astype(np.float32) for a in _problem(n, q, j, 0, 1))
    out = mesh_lib.spawn_workers(_sharded_rank, RANKS, y, t, backend="gloo", device="cpu",
                                 threads=1, join_timeout_s=300)
    zs = [z for z, _, _ in out]
    assert all(np.array_equal(z, zs[0]) for z in zs[1:])
    oracle = admm.exact_constrained_ridge(_t(y), _t(t), eps_radius=6.0).numpy()
    yw = _t(y).reshape(n, RANKS, j // RANKS).transpose(0, 1).contiguous()
    tw = _t(t).reshape(q, RANKS, j // RANKS).transpose(0, 1).contiguous()
    sim = admm.admm_ridge_consensus(yw, tw, mu=1e-2, eps_radius=6.0, num_iters=300)
    assert _rel(zs[0], oracle) < ORACLE_REL
    assert float(np.abs(zs[0] - sim.o_star.numpy()).max()) <= 1e-5
    assert out[0][2]["all-reduce"] == 300 + 1
    np.testing.assert_allclose(out[0][1], sim.trace.objective.numpy(), rtol=1e-5)


def test_slow_consensus_is_the_algorithms():
    """With fewer samples a worker (64) than features (192) and feature
    scales spread over 1.5 decades, consensus ADMM at mu=1e-2 is still far
    from the centralized readout at K=200 (examples/layerwise_readout.py
    asks 1e-2 of its own geometry), in ``repro`` as in the port: the two
    packages' decentralized readouts agree within 1e-4, and the gap
    shrinks by more than 4x by K=1000 (measured 0.402, then 0.027)."""
    rng = np.random.default_rng(0)
    n, j, q, m = 192, 256, 10, 4
    y = (np.logspace(0, 1.5, n)[:, None] * rng.normal(size=(n, j))).astype(np.float32)
    t = np.eye(q, dtype=np.float32)[rng.integers(0, q, j)].T.copy()
    yw = np.ascontiguousarray(y.reshape(n, m, j // m).transpose(1, 0, 2))
    tw = np.ascontiguousarray(t.reshape(q, m, j // m).transpose(1, 0, 2))
    kw = dict(mu=1e-2, eps_radius=2.0 * q)
    want = np.asarray(j_admm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw),
                                                 num_iters=200, **kw).o_star)
    gaps = []
    for k in (200, 1000):
        dec = admm.admm_ridge_consensus(_t(yw), _t(tw), num_iters=k, **kw).o_star.numpy()
        cen = readout.fit_readout(_t(y), _t(t), num_iters=k, **kw).numpy()
        gaps.append(_rel(dec, cen))
        if k == 200:
            assert _rel(dec, want) < READOUT_REL
    assert gaps[0] > 1e-2 and gaps[1] < gaps[0] / 4, gaps
