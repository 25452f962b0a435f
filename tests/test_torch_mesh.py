"""``MeshBackend`` over ``torch.distributed``: the worker program in W
gloo ranks on the CPU, each holding a block of M/W workers, against
repro's ``SimulatedBackend``/``MeshBackend`` and the port's own
``SimulatedBackend`` on the same numpy inputs.

Ranks are spawned with ``launch.mesh.spawn_workers`` (one intra-op
thread each, a bounded join that kills stragglers); W=4 except where a
case needs W=M=8.  Bars (the reference's sim-vs-mesh bars,
``tests/test_multidevice.py:128-131, 177``):

- exchange plans: every rank's pool index gives each held worker the
  message of its source, exactly;
- the hot path (W=M=8, K=10): ``trace_every=0`` issues exactly K x the
  policy's hops of collective-permutes and no reduction (one all-reduce
  a mix for ExactMean), what repro's wire model expects; ``trace_every=1``
  adds exactly 4K all-reduces (2K under ExactMean, which skips the
  consensus error); the iterate does not depend on it;
- a 2-layer facade train: layer costs and readouts within 1e-4 of the
  port's simulated train and of repro's; a second mesh train bit-equal;
- a mesh checkpoint (rank 0 writes it) resumes under the port's
  ``SimulatedBackend`` and in repro, within 1e-4 of their uninterrupted
  runs;
- the launcher's ``--backend both --device cpu --ranks 4``: repro's run
  and parity keys, parity within 1e-4, launches summed over ranks;
- one rank in this process against repro's
  ``MeshBackend(make_worker_mesh(1))``: o_star and layer costs within
  1e-4.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import dssfn as tdssfn
from repro_torch import prng
from repro_torch.core import admm, layerwise
from repro_torch.core import ssfn as tssfn
from repro_torch.core.backend import MeshBackend, SimulatedBackend, make_backend
from repro_torch.core.policy import ExactMean, RingGossip
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train_dssfn

M, N, Q, J = 8, 16, 3, 256
GAP = 1e-4
CFG = dict(input_dim=10, num_classes=3, num_layers=2, hidden=24, admm_iters=20)


def _spawn(fn, ranks, *args, workers=M):
    return mesh_lib.spawn_workers(
        fn, ranks, *args, num_workers=workers, backend="gloo", device="cpu",
        threads=1, join_timeout_s=300,
    )


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _problem():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, J)).astype(np.float32)
    t = rng.standard_normal((Q, J)).astype(np.float32)
    yw = np.ascontiguousarray(y.reshape(N, M, J // M).transpose(1, 0, 2))
    tw = np.ascontiguousarray(t.reshape(Q, M, J // M).transpose(1, 0, 2))
    return yw, tw


def _train_data(m=M, seed=2):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((m, CFG["input_dim"], 24)).astype(np.float32)
    labels = rng.integers(0, CFG["num_classes"], (m, 24))
    tw = np.eye(CFG["num_classes"], dtype=np.float32)[labels].transpose(0, 2, 1)
    return xw, np.ascontiguousarray(tw)


# ------------------------------------------------------------ exchange plans

def _perm_sets():
    rng = np.random.default_rng(3)
    ring = tuple(tuple((i, (i + k) % M) for i in range(M)) for k in (1, -1, 3))
    rand = tuple(tuple(zip(rng.permutation(M).tolist(), range(M))) for _ in range(3))
    return {"ring": ring, "random": rand, "identity": (tuple((i, i) for i in range(M)),)}


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["ring", "random", "identity"])
def test_exchange_plan_delivers_every_message(ranks, kind):
    """Play every rank's plan: the rows each rank sends are what its
    peers expect, and each pool index picks the source's message."""
    perms = _perm_sets()[kind]
    x = np.arange(M * 2, dtype=np.float32).reshape(M, 2)
    m = M // ranks
    plans = [mesh_lib.exchange_plan(perms, M, r, ranks) for r in range(ranks)]
    for r, (index, recv_rows, _) in enumerate(plans):
        own = x[r * m:(r + 1) * m]
        pool = [own]
        for peer in sorted(recv_rows):
            sent = plans[peer][2][r]
            assert len(sent) == recv_rows[peer]
            pool.append(x[peer * m:(peer + 1) * m][sent])
        got = np.concatenate(pool)[index].reshape(len(perms), m, 2)
        for s, perm in enumerate(perms):
            src_of = {d: src for src, d in perm}
            want = np.stack([x[src_of[d]] for d in range(r * m, (r + 1) * m)])
            assert np.array_equal(got[s], want)
        assert r not in recv_rows and r not in plans[r][2]


# ---------------------------------------------------------------- hot path

def _hot_path_rank(group):
    """K=10 ADMM iterations on this rank's worker, traced and untraced, under
    RingGossip(4, 2) and ExactMean: the collectives each issued."""
    yw, tw = _problem()
    out = {}
    for name, pol in (("ring", RingGossip(4, 2)), ("exact", ExactMean())):
        backend = MeshBackend(group, policy=pol)
        y_b = backend.shard_workers(torch.from_numpy(yw))
        t_b = backend.shard_workers(torch.from_numpy(tw))
        a, chol, _ = admm._worker_stats(y_b, t_b, 1e-2)
        z0 = torch.zeros(Q, N)
        for trace_every in (0, 1):
            backend.reset_collective_counts()
            (o, z, lam), _ = admm.worker_admm_iterations(
                backend, a, chol, y_b, t_b, z0, mu=1e-2, eps_radius=6.0, num_iters=10,
                policy=pol, trace_every=trace_every)
            out[name, trace_every] = (backend.collective_counts(), z.numpy())
    return out


def test_hot_path_issues_only_the_policys_exchanges():
    from repro import analysis
    from repro.core import policy as jp

    per_rank = _spawn(_hot_path_rank, M)
    k = 10
    for name, jpol in (("ring", jp.RingGossip(4, 2)), ("exact", jp.ExactMean())):
        want = {op: k * c for op, c in analysis.expected_mix_collectives(jpol, M).items()}
        for r in per_rank:
            hot, z_hot = r[name, 0]
            traced, z_traced = r[name, 1]
            assert hot == want, (name, hot, want)
            per_iter = 2 if name == "exact" else 4
            assert traced == {**want, "all-reduce": want.get("all-reduce", 0) + per_iter * k}
            assert np.array_equal(z_hot, z_traced)
    assert RingGossip(4, 2).hops_for(M) == analysis.expected_mix_collectives(
        jp.RingGossip(4, 2), M)["collective-permute"]


# ------------------------------------------------------------------- trains

def _train_rank(group, policy, ckpt_dir):
    """Two 2-layer mesh trains from this rank's block: the first traced
    and checkpointed after every layer into ``ckpt_dir``, the second
    untraced (it must repeat the first's readouts bit for bit).  Each
    rank returns the readouts, layer costs, eq.-15 scalars and the
    jitter levels' shape."""
    xw, tw = _train_data()
    cfg = tssfn.SSFNConfig(**CFG)
    backend = MeshBackend(group, policy=policy)
    xb, tb = backend.shard_workers(torch.from_numpy(xw)), backend.shard_workers(
        torch.from_numpy(tw))
    runs = [layerwise.train_decentralized_ssfn(
        xb, tb, cfg, key=prng.PRNGKey(1), backend=backend, **kw)
        for kw in (dict(checkpoint_dir=ckpt_dir), dict(trace_every=0))]
    return [([o.numpy() for o in p.o], log.layer_costs, log.comm_scalars,
             log.jitter_levels.shape) for p, log in runs]


@pytest.fixture(scope="module")
def mesh_trains(tmp_path_factory):
    out = {}
    for name, pol in (("exact", ExactMean()), ("gossip", RingGossip(6, 2))):
        ckpt = str(tmp_path_factory.mktemp(f"mesh_ckpt_{name}"))
        out[name] = (_spawn(_train_rank, 4, pol, ckpt), ckpt, pol)
    return out


def _jpolicy(pol):
    from repro.core import policy as jp

    return jp.ExactMean() if isinstance(pol, ExactMean) else jp.RingGossip(6, 2)


def _reference_train(pol, **kw):
    import jax
    import jax.numpy as jnp

    from repro.core import layerwise as jlayerwise
    from repro.core import ssfn as jssfn
    from repro.core.backend import SimulatedBackend as JBackend

    xw, tw = _train_data()
    return jlayerwise.train_decentralized_ssfn(
        jnp.asarray(xw), jnp.asarray(tw), jssfn.SSFNConfig(**CFG), jax.random.PRNGKey(1),
        backend=JBackend(M, policy=_jpolicy(pol)), **kw)


@pytest.mark.parametrize("name", ["exact", "gossip"])
def test_mesh_train_matches_simulated_and_reference(mesh_trains, name):
    per_rank, _, pol = mesh_trains[name]
    xw, tw = _train_data()
    sim_p, sim_log = layerwise.train_decentralized_ssfn(
        torch.from_numpy(xw), torch.from_numpy(tw), tssfn.SSFNConfig(**CFG),
        key=prng.PRNGKey(1), backend=SimulatedBackend(M, policy=pol))
    ref_p, ref_log = _reference_train(pol)
    for r in per_rank:
        (o1, costs1, comm1, jit_shape), (o2, costs2, comm2, _) = r
        assert all(np.array_equal(a, b) for a, b in zip(o1, o2)) and costs2 == []
        assert comm1 == comm2 == sim_log.comm_scalars == ref_log.comm_scalars
        assert jit_shape == (CFG["num_layers"] + 1, M)
        for a, s, j in zip(o1, sim_p.o, ref_p.o):
            assert _rel(a, s.numpy()) < GAP
            assert _rel(a, np.asarray(j)) < GAP
        np.testing.assert_allclose(costs1, sim_log.layer_costs, rtol=GAP)
        np.testing.assert_allclose(costs1, ref_log.layer_costs, rtol=GAP)
        # Every rank holds the same readouts: o_star is gathered.
        assert all(np.array_equal(a, b) for a, b in zip(o1, per_rank[0][0][0]))


@pytest.mark.parametrize("name", ["exact", "gossip"])
def test_mesh_checkpoint_resumes_under_simulated_and_in_reference(mesh_trains, name, tmp_path):
    """Rank 0 wrote the whole state in repro's schema; the port's
    simulated backend and repro resume it to their own full runs."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import store as jstore
    from repro.core import layerwise as jlayerwise
    from repro.core import ssfn as jssfn
    from repro.core.backend import SimulatedBackend as JBackend

    per_rank, ckpt, pol = mesh_trains[name]
    assert os.path.basename(layerwise.latest_checkpoint(ckpt)) == "dssfn_layer_003.npz"
    flat = jstore.load_pytree_flat(os.path.join(ckpt, "dssfn_layer_001.npz"))
    assert flat["y_workers"].shape == (M, CFG["input_dim"], 24)
    assert flat["o_workers"].shape == flat["lam"].shape == (M, Q, CFG["input_dim"])
    # Each package resumes a copy of the mesh's layer-0 checkpoint.
    dirs = [tmp_path / "port", tmp_path / "repro"]
    for d in dirs:
        d.mkdir()
        for f in os.listdir(ckpt):
            if f.startswith("dssfn_layer_001"):
                (d / f).write_bytes(open(os.path.join(ckpt, f), "rb").read())
    xw, tw = _train_data()
    full = per_rank[0][0][0]
    res_p, _ = layerwise.train_decentralized_ssfn(
        torch.from_numpy(xw), torch.from_numpy(tw), tssfn.SSFNConfig(**CFG),
        key=prng.PRNGKey(1), backend=SimulatedBackend(M, policy=pol),
        checkpoint_dir=str(dirs[0]), resume=True)
    jres_p, _ = jlayerwise.train_decentralized_ssfn(
        jnp.asarray(xw), jnp.asarray(tw), jssfn.SSFNConfig(**CFG), jax.random.PRNGKey(1),
        backend=JBackend(M, policy=_jpolicy(pol)), checkpoint_dir=str(dirs[1]), resume=True)
    ref_p, _ = _reference_train(pol)
    assert np.array_equal(res_p.o[0].numpy(), full[0])
    assert np.array_equal(np.asarray(jres_p.o[0]), full[0])
    for a, b, c, d in zip(res_p.o, jres_p.o, full, ref_p.o):
        assert _rel(a.numpy(), c) < GAP
        assert _rel(np.asarray(b), c) < GAP
        assert _rel(np.asarray(b), np.asarray(d)) < GAP


# ---------------------------------------------------------------- launcher

LAUNCH_ARGS = ["--device", "cpu", "--workers", "8", "--layers", "2", "--hidden", "40",
               "--admm-iters", "20", "--train", "480", "--test", "120"]


@pytest.mark.parametrize("consensus", ["exact", "gossip:4:2"])
def test_launcher_both_reports_reference_parity_keys(consensus):
    from repro.launch import train_dssfn as jlaunch

    res = train_dssfn.main(LAUNCH_ARGS + ["--backend", "both", "--ranks", "4",
                                          "--consensus", consensus])
    jres = jlaunch.main(LAUNCH_ARGS[2:] + ["--backend", "simulated", "--no-host-mesh",
                                           "--consensus", consensus])
    sim, msh = res["runs"]
    assert sim["kind"] == "simulated" and msh["kind"] == "mesh"
    assert set(jres["runs"][0]) <= set(msh) and set(jres["runs"][0]) <= set(sim)
    assert msh["ranks"] == 4 and msh["dist_backend"] == "gloo"
    assert msh["kernel_launches"] == {"gram": 0, "propagate_gram": 0, "matmul_relu": 0}
    assert len(msh["per_rank"]) == 4
    assert msh["comm_scalars"] == sim["comm_scalars"] == jres["runs"][0]["comm_scalars"]
    assert {"max_readout_rel_gap", "rel_objective_gap"} <= set(res["parity"])
    assert res["parity"]["max_readout_rel_gap"] < GAP
    assert res["parity"]["rel_objective_gap"] < GAP
    assert "transport=gloo" in msh["backend"]
    want = "all-reduce" if consensus == "exact" else "collective-permute"
    assert msh["collective_counts"][want] > 0


def test_launcher_mesh_one_rank_in_process_matches_spawned():
    one = train_dssfn.main(LAUNCH_ARGS + ["--backend", "mesh", "--ranks", "1"])
    two = train_dssfn.main(LAUNCH_ARGS + ["--backend", "mesh", "--ranks", "2"])
    a, b = one["runs"][0], two["runs"][0]
    assert a["ranks"] == 1 and b["ranks"] == 2
    assert abs(a["final_objective"] - b["final_objective"]) <= GAP * a["final_objective"]
    assert a["comm_scalars"] == b["comm_scalars"]


def test_launcher_refuses_a_rank_count_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        train_dssfn.main(LAUNCH_ARGS + ["--backend", "mesh", "--ranks", "3"])


# ------------------------------------------------------ one rank, in process

def test_one_rank_mesh_matches_reference_mesh():
    """The port's one-rank group against repro's
    ``MeshBackend(make_worker_mesh(1))``: an ADMM solve and a 2-layer
    facade train of one worker."""
    import jax
    import jax.numpy as jnp

    from repro import dssfn as jdssfn
    from repro.core import admm as jadmm
    from repro.core import ssfn as jssfn
    from repro.core.backend import MeshBackend as JMeshBackend
    from repro.launch.mesh import make_worker_mesh

    yw, tw = _problem()
    y1, t1 = yw.transpose(1, 0, 2).reshape(N, J)[None], tw.transpose(1, 0, 2).reshape(Q, J)[None]
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=100)
    group = mesh_lib.make_worker_group(1, device="cpu")
    got = admm.admm_ridge_consensus(torch.from_numpy(y1), torch.from_numpy(t1),
                                    backend=MeshBackend(group), **kw)
    want = jadmm.admm_ridge_consensus(jnp.asarray(y1), jnp.asarray(t1),
                                      backend=JMeshBackend(make_worker_mesh(1)), **kw)
    assert _rel(got.o_star.numpy(), np.asarray(want.o_star)) < GAP
    np.testing.assert_allclose(got.trace.objective.numpy(), np.asarray(want.trace.objective),
                               rtol=GAP)

    xw, tw2 = _train_data(m=1)
    spec = tdssfn.TrainSpec(cfg=tssfn.SSFNConfig(**CFG), backend="mesh", mesh=group)
    res = tdssfn.train(spec, torch.from_numpy(xw), torch.from_numpy(tw2), key=prng.PRNGKey(1))
    jspec = jdssfn.TrainSpec(cfg=jssfn.SSFNConfig(**CFG),
                             backend=JMeshBackend(make_worker_mesh(1)))
    jres = jdssfn.train(jspec, jnp.asarray(xw), jnp.asarray(tw2), jax.random.PRNGKey(1))
    assert isinstance(res.backend, MeshBackend) and res.backend.num_workers == 1
    np.testing.assert_allclose(res.log.layer_costs, jres.log.layer_costs, rtol=GAP)
    for a, b in zip(res.params.o, jres.params.o):
        assert _rel(a.numpy(), np.asarray(b)) < GAP


def test_one_rank_mesh_holds_every_worker_like_simulated():
    """One rank may hold all M workers: the same train as the simulated
    backend, bit for bit wherever no reduction reorders a sum."""
    xw, tw = _train_data()
    cfg = tssfn.SSFNConfig(**CFG)
    group = mesh_lib.make_worker_group(M, device="cpu")
    pol = RingGossip(6, 2)
    mp, mlog = layerwise.train_decentralized_ssfn(
        torch.from_numpy(xw), torch.from_numpy(tw), cfg, key=prng.PRNGKey(1),
        backend=make_backend("mesh", M, mesh=group, policy=pol))
    sp, slog = layerwise.train_decentralized_ssfn(
        torch.from_numpy(xw), torch.from_numpy(tw), cfg, key=prng.PRNGKey(1),
        backend=make_backend("simulated", M, policy=pol))
    assert all(torch.equal(a, b) for a, b in zip(mp.o, sp.o))
    np.testing.assert_allclose(mlog.layer_costs, slog.layer_costs, rtol=1e-6)


# ---------------------------------------------------------- refusals, hangs

def _fail_on_rank_1(group):
    if group.rank == 1:
        raise ValueError("rank one refuses")
    group.transport.barrier()   # left waiting for rank 1
    return group.rank


def test_a_failing_rank_fails_the_run_and_stops_the_others():
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed(.|\n)*rank one refuses"):
        mesh_lib.spawn_workers(_fail_on_rank_1, 3, backend="gloo", device="cpu", threads=1,
                               timeout_s=30, join_timeout_s=60)


def test_worker_groups_refuse_what_they_cannot_run():
    with pytest.raises(ValueError, match="spawn_workers"):
        mesh_lib.make_worker_group(8, ranks=2, device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        mesh_lib.make_worker_group(8, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        mesh_lib.WorkerGroup(8, 0, 3, "gloo", torch.device("cpu"), None)
    with pytest.raises(TypeError, match="WorkerGroup"):
        tdssfn.TrainSpec(cfg=tssfn.SSFNConfig(**CFG), backend="mesh", mesh=object())
    with pytest.raises(TypeError, match="WorkerGroup"):
        MeshBackend(object())
    group = mesh_lib.make_worker_group(4, device="cpu")
    backend = MeshBackend(group)
    with pytest.raises(ValueError, match="leading dim 3"):
        backend.shard_workers(torch.zeros(3, 2))
    assert backend.describe() == "MeshBackend(M=4, policy=ExactMean(), ranks=1, transport=gloo)"
    assert dataclasses.asdict(group.transport.stats)["counts"] == {}
