"""The backend's API surface against repro's ``ConsensusBackend``.

Ports the cases of ``tests/test_backend.py`` that ``test_torch_admm.py``
and ``test_torch_mesh.py`` do not already cover: the eq.-15 count
``exchanges_per_consensus`` (and the layer-wise comm accounting it
drives), the legacy ``mode``/``degree``/``num_rounds`` views,
``map_workers``, ``worker_index``, the default backend, the backend
argument of the layer-wise train, and the error paths of
``make_backend`` and of the constructors.  Also the program record that
``lowering_texts``/``lowering_stats`` join, as ``repro``'s share its
executable cache.
"""
import numpy as np
import pytest
import torch

from repro_torch import analysis, dssfn
from repro_torch.core import admm, layerwise, ssfn
from repro_torch.core.backend import MeshBackend, SimulatedBackend, make_backend
from repro_torch.core.policy import ExactMean, RingGossip
from repro_torch.launch import mesh as mesh_lib

M = 8
SPECS = [e.spec for e in analysis.ALL_GRAMMAR]


def _jbackend(spec, m=M):
    from repro import dssfn as jdssfn
    from repro.core.backend import SimulatedBackend as JBackend

    return JBackend(m, policy=jdssfn.parse_spec(spec))


@pytest.mark.parametrize("spec", SPECS)
def test_exchanges_per_consensus_and_legacy_views_match_reference(spec):
    backend = SimulatedBackend(M, policy=dssfn.parse_spec(spec))
    ref = _jbackend(spec)
    assert backend.exchanges_per_consensus() == ref.exchanges_per_consensus()
    assert (backend.mode, backend.degree, backend.num_rounds) == (
        ref.mode, ref.degree, ref.num_rounds)


def _train_data(m, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((m, 8, 16)).astype(np.float32)
    labels = rng.integers(0, 3, (m, 16))
    tw = np.eye(3, dtype=np.float32)[labels].transpose(0, 2, 1)
    return torch.from_numpy(xw), torch.from_numpy(np.ascontiguousarray(tw))


def test_layerwise_gossip_backend_comm_accounting():
    m = 4
    cfg = ssfn.SSFNConfig(input_dim=8, num_classes=3, num_layers=1, hidden=20, admm_iters=10)
    xw, tw = _train_data(m, 7)
    backend = SimulatedBackend(m, policy=RingGossip(rounds=3, degree=1))
    _, log = layerwise.train_decentralized_ssfn(
        xw, tw, cfg, generator=torch.Generator().manual_seed(7), backend=backend)
    # eq. 15 with B = 2*degree*rounds exchanges per consensus.
    assert backend.exchanges_per_consensus() == 6
    assert log.comm_scalars == 3 * (8 + 20) * 6 * 10  # Q*(n_0 + n_1)*B*K


def test_layerwise_training_accepts_backend():
    m = 4
    cfg = ssfn.SSFNConfig(input_dim=8, num_classes=3, num_layers=1, hidden=20, admm_iters=30)
    xw, tw = _train_data(m, 6)
    runs = [layerwise.train_decentralized_ssfn(
        xw, tw, cfg, generator=torch.Generator().manual_seed(6), **kw)
        for kw in ({}, dict(backend=SimulatedBackend(m)))]
    for a, b in zip(runs[0][0].o, runs[1][0].o):
        assert torch.allclose(a, b, atol=1e-6)
    assert runs[0][1].comm_scalars == runs[1][1].comm_scalars


def test_default_backend_is_simulated_exact():
    rng = np.random.default_rng(1)
    yw = torch.from_numpy(rng.standard_normal((4, 16, 40)).astype(np.float32))
    tw = torch.from_numpy(rng.standard_normal((4, 3, 40)).astype(np.float32))
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=50)
    a = admm.admm_ridge_consensus(yw, tw, **kw)
    b = admm.admm_ridge_consensus(yw, tw, backend=SimulatedBackend(4), **kw)
    assert torch.equal(a.o_star, b.o_star)
    assert torch.equal(a.trace.objective, b.trace.objective)


def test_map_workers_is_run_without_collectives():
    import jax.numpy as jnp

    backend = SimulatedBackend(4)
    x = torch.arange(24.0).reshape(4, 2, 3)
    got = backend.map_workers(lambda a, s: a * s + a.sum(-1, keepdim=True), x,
                              replicated=(torch.tensor(2.0),), key="local")
    ref = _jbackend("exact", 4)
    want = ref.map_workers(lambda a, s: a * s + a.sum(-1, keepdims=True),
                           jnp.asarray(x.numpy()), replicated=(jnp.asarray(2.0),), key="local")
    assert np.array_equal(got.numpy(), np.asarray(want))
    # A local program is its own entry beside the same key under run().
    backend.run(lambda a, s: a * s, x, replicated=(torch.tensor(2.0),), key="local")
    backend.map_workers(lambda a, s: a, x, replicated=(torch.tensor(2.0),), key="local")
    info = backend.cache_info()
    assert info["entries"] == 2 and info["cache_hits"] == 1


def test_map_workers_refuses_a_collective_on_the_mesh():
    group = mesh_lib.make_worker_group(2, device="cpu")
    backend = MeshBackend(group)
    x = torch.ones(2, 3)
    assert torch.equal(backend.map_workers(lambda a: a + 1, x), x + 1)
    with pytest.raises(RuntimeError, match="made a collective"):
        backend.map_workers(lambda a: backend.psum(a), x)


@pytest.mark.parametrize("rank,ranks", [(0, 1), (1, 2), (3, 4)])
def test_worker_index_is_the_held_workers(rank, ranks):
    import jax.numpy as jnp

    ref = _jbackend("exact")
    want = np.asarray(ref.run(lambda x: ref.worker_index(), jnp.zeros((M, 1))))
    assert SimulatedBackend(M).worker_index().tolist() == want.tolist()
    group = mesh_lib.WorkerGroup(M, rank, ranks, "gloo", torch.device("cpu"), None)
    backend = MeshBackend(group)
    assert backend.worker_index().tolist() == want[backend.rows].tolist()


def test_make_backend_error_paths():
    with pytest.raises(ValueError, match="unknown backend kind"):
        make_backend("tpu-pod")
    with pytest.raises(ValueError, match="num_workers"):
        make_backend("simulated")
    group = mesh_lib.make_worker_group(4, device="cpu")
    with pytest.raises(ValueError, match="num_workers=8"):
        make_backend("mesh", 8, mesh=group)
    backend = make_backend("simulated", 8, policy="gossip:4", degree=2)
    assert backend.policy == RingGossip(4, 2)
    assert make_backend("mesh", 4, mesh=group).num_workers == 4
    assert dssfn.make_backend is make_backend


def test_backend_validation():
    with pytest.raises(TypeError, match="mode.*removed.*parse_policy"):
        SimulatedBackend(4, mode="psum")
    with pytest.raises(TypeError, match="degree, mode"):
        SimulatedBackend(4, mode="gossip", degree=0)
    with pytest.raises(TypeError, match="num_rounds"):
        SimulatedBackend(4, num_rounds=0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        SimulatedBackend(4, axis="workers")
    with pytest.raises(TypeError, match="num_rounds"):
        MeshBackend(None, num_rounds=2)
    with pytest.raises(ValueError, match="num_workers"):
        SimulatedBackend(0)
    with pytest.raises(TypeError, match="policy must be a ConsensusPolicy"):
        SimulatedBackend(4, policy="gossip:2")
    with pytest.raises(TypeError, match="WorkerGroup"):
        MeshBackend(object())


def test_lowering_texts_join_the_program_record():
    """As repro's share the executable cache with run: a probe is one
    more entry, a repeat (by run or by probe) one more hit."""
    backend = SimulatedBackend(4)
    x = torch.ones(4, 3, 5)

    def prog(a):
        return a @ a.mT

    texts = backend.lowering_texts(prog, x, key="p")
    assert backend.cache_info()["entries"] == 1
    backend.run(prog, x, key="p")
    backend.lowering_stats(prog, x, key="p")
    info = backend.cache_info()
    assert info["entries"] == 1 and info["cache_hits"] == 2
    assert texts["record"].splitlines()[-1].endswith("matmul -> f32[4,3,3]")
    assert texts["collective_counts"] == {}
    stats = backend.lowering_stats(prog, x, key="p")
    assert stats["call_counts"]["matmul"] == 1 and stats["collective_wire_bytes"] == 0


def test_lowering_stats_count_the_mesh_transport():
    group = mesh_lib.make_worker_group(4, device="cpu")
    backend = MeshBackend(group, policy=ExactMean())
    x = torch.ones(4, 2, 3)
    backend.psum(x)  # counted before the probe, not in it
    stats = backend.lowering_stats(lambda a: backend.consensus_mean(a), x, key="mix")
    assert stats["collective_counts"] == {"all-reduce": 1}
    assert stats["collective_bytes"] == {"all-reduce": 2 * 3 * 4}
    assert stats["collective_wire_bytes"] == 24
    assert stats["collective_dtypes"] == {"all-reduce": {"float32": 1}}
    assert backend.collective_counts() == {"all-reduce": 2}
