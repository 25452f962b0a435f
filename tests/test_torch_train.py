"""repro_torch's training slice against repro's, with repro's random
matrices and dataset carried across as numpy arrays.

Configuration: P=32, Q=4, n=128, L=3, M=4, J=1024 (J_m = 256 >= n keeps
each local Gram well conditioned), K=30, mu0 = mul = 1e-1 (the free ADMM
penalty at which these sizes converge, as ``tests/test_system.py``
explains).

Tolerances: per-layer readouts and predictions within a relative
Frobenius gap of 1e-4.  Each of the 4 layer solves runs K f32 ADMM
iterations from Grams that the two packages sum in different orders; the
measured gaps are below 1e-5 at these sizes, so 1e-4 leaves a margin of
10 without hiding a real mismatch.  Argmax agreement >= 0.99; the
equivalence report's fields within 1e-3 of repro's; everything counted
(communication scalars, jitter levels, partitions) exactly equal.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import dssfn as jdssfn
from repro.core import equivalence as jeq
from repro.core import layerwise as jl
from repro.core import ssfn as js
from repro.data import make_classification as j_make
from repro.data import partition_by_spec as j_partition
from repro.data import partition_workers as j_part
from repro_torch import dssfn, prng
from repro_torch.convert import dataset_from_numpy, r_from_numpy
from repro_torch.core import equivalence, layerwise, ssfn
from repro_torch.core.policy import ExactMean
from repro_torch.data import (
    make_classification,
    paper_dataset,
    partition_by_spec,
    partition_workers,
)

GEOM = dict(input_dim=32, num_classes=4, num_layers=3, hidden=128,
            mu0=1e-1, mul=1e-1, admm_iters=30)
M = 4
GAP = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def runs():
    data = j_make(jax.random.PRNGKey(0), num_train=1024, num_test=256,
                  input_dim=32, num_classes=4)
    jcfg = js.SSFNConfig(**GEOM)
    key = jax.random.PRNGKey(1)
    r = [np.asarray(a) for a in js.init_random_matrices(key, jcfg)]
    xw, tw = j_part(data.x_train, data.t_train, M)
    j_dec = jl.train_decentralized_ssfn(xw, tw, jcfg, key)
    j_cen = jl.train_centralized_ssfn(data.x_train, data.t_train, jcfg, key)

    cfg = ssfn.SSFNConfig(**GEOM)
    td = dataset_from_numpy(data, device="cpu")
    txw, ttw = partition_workers(td.x_train, td.t_train, M)
    t_r = r_from_numpy(r, device="cpu")
    t_dec = layerwise.train_decentralized_ssfn(txw, ttw, cfg, r=t_r)
    t_cen = layerwise.train_centralized_ssfn(td.x_train, td.t_train, cfg, r=t_r)
    return dict(data=data, td=td, cfg=cfg, r=t_r,
                jax={"dec": j_dec, "cen": j_cen}, torch={"dec": t_dec, "cen": t_cen})


@pytest.mark.parametrize("kind", ["dec", "cen"])
def test_readouts_and_predictions_match_reference(runs, kind):
    (jp, jlog), (tp, tlog) = runs["jax"][kind], runs["torch"][kind]
    assert len(tp.o) == len(jp.o) == 4 and len(tp.r) == 3
    for l, (a, b) in enumerate(zip(tp.o, jp.o)):
        assert _rel(a.numpy(), b) <= GAP, l
    for a, b in zip(tp.r, jp.r):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x = runs["data"].x_test
    want = np.asarray(js.predict(jp, x, 4))
    got = ssfn.predict(tp, runs["td"].x_test, 4).numpy()
    assert _rel(got, want) <= GAP
    assert (got.argmax(0) == want.argmax(0)).mean() >= 0.99


@pytest.mark.parametrize("kind", ["dec", "cen"])
def test_log_matches_reference(runs, kind):
    (_, jlog), (_, tlog) = runs["jax"][kind], runs["torch"][kind]
    assert tlog.comm_scalars == jlog.comm_scalars
    assert np.array_equal(tlog.jitter_levels, np.asarray(jlog.jitter_levels))
    assert tlog.admm_objective.shape == jlog.admm_objective.shape == (4, 30)
    np.testing.assert_allclose(tlog.layer_costs, jlog.layer_costs, rtol=1e-4)
    np.testing.assert_allclose(tlog.admm_objective, jlog.admm_objective, rtol=1e-4)
    assert tlog.rollbacks == jlog.rollbacks == 0


def test_equivalence_report_matches_reference(runs):
    got = equivalence.compare(runs["torch"]["cen"][0], runs["torch"]["dec"][0],
                              runs["td"].x_test, 4)
    want = jeq.compare(runs["jax"]["cen"][0], runs["jax"]["dec"][0],
                       runs["data"].x_test, 4)
    for field in got._fields:
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-3, field
    assert got.agreement >= 0.85


def test_size_estimation_stops_at_the_reference_depth():
    """The relative layer-cost improvements of this problem are 0.60,
    0.10, 0.08, 0.04, 0.02, 0.018 (repro); a tolerance of 0.06 stops
    after the fifth solve, away from every knife edge."""
    data = j_make(jax.random.PRNGKey(2), num_train=512, num_test=128,
                  input_dim=16, num_classes=3)
    geom = dict(input_dim=16, num_classes=3, num_layers=6, hidden=40,
                mu0=1e-1, mul=1e-1, admm_iters=20)
    key = jax.random.PRNGKey(3)
    jcfg = js.SSFNConfig(**geom)
    r = [np.asarray(a) for a in js.init_random_matrices(key, jcfg)]
    xw, tw = j_part(data.x_train, data.t_train, 4)
    jp, _ = jl.train_decentralized_ssfn(xw, tw, jcfg, key, size_estimation_tol=0.06)
    td = dataset_from_numpy(data, device="cpu")
    txw, ttw = partition_workers(td.x_train, td.t_train, 4)
    tp, tlog = layerwise.train_decentralized_ssfn(
        txw, ttw, ssfn.SSFNConfig(**geom), r=r_from_numpy(r, device="cpu"),
        size_estimation_tol=0.06,
    )
    assert len(tp.o) == len(jp.o) == 5
    assert len(tp.r) == len(jp.r) == 4 and len(tlog.layer_costs) == 5
    with pytest.raises(ValueError, match="trace_every=0"):
        layerwise.train_decentralized_ssfn(
            txw, ttw, ssfn.SSFNConfig(**geom), r=r_from_numpy(r, device="cpu"),
            size_estimation_tol=0.06, trace_every=0,
        )


@pytest.mark.parametrize("spec", ["iid", "noniid", "noniid:0.5", "noniid:0.3"])
def test_partitions_equal_reference_bit_for_bit(spec):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 1030)).astype(np.float32)
    t = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 1030)].T.copy()
    jx, jt = j_partition(jax.numpy.asarray(x), jax.numpy.asarray(t), 4, spec)
    tx, tt = partition_by_spec(torch.from_numpy(x), torch.from_numpy(t), 4, spec)
    assert tx.shape == (4, 5, 257)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_partition_specs_are_validated():
    x, t = torch.zeros((2, 8)), torch.zeros((3, 8))
    for bad in ("iid:1", "noniid:0", "noniid:2", "skewed"):
        with pytest.raises(ValueError, match="partition"):
            partition_by_spec(x, t, 2, bad)


def test_make_classification_shapes_onehot_and_standardized():
    data = make_classification(torch.Generator().manual_seed(0), num_train=600,
                               num_test=100, input_dim=12, num_classes=5)
    assert data.x_train.shape == (12, 600) and data.x_test.shape == (12, 100)
    assert data.t_train.shape == (5, 600) and data.y_test.shape == (100,)
    assert data.input_dim == 12 and data.num_classes == 5
    assert torch.equal(data.t_train.sum(0), torch.ones(600))
    assert torch.equal(data.t_train.argmax(0), data.y_train)
    assert data.x_train.mean(1).abs().max() < 1e-5
    assert (data.x_train.std(1, correction=0) - 1).abs().max() < 1e-4
    assert len(data.y_train.unique()) > 1
    again = make_classification(torch.Generator().manual_seed(0), num_train=600,
                                num_test=100, input_dim=12, num_classes=5)
    assert torch.equal(again.x_train, data.x_train)
    mnist = paper_dataset("mnist", torch.Generator().manual_seed(0), scale=0.01)
    assert mnist.x_train.shape == (784, 600) and mnist.num_classes == 10


def test_init_random_matrices_shapes_scale_and_seed():
    cfg = ssfn.SSFNConfig(input_dim=20, num_classes=3, num_layers=3, hidden=400)
    rs = ssfn.init_random_matrices(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(r.shape) for r in rs] == [(394, 20), (394, 400), (394, 400)]
    assert abs(float(rs[1].std()) - 400**-0.5) < 0.05 * 400**-0.5
    again = ssfn.init_random_matrices(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(rs, again))


def test_generator_or_r_exactly_one(runs):
    cfg, r = runs["cfg"], runs["r"]
    xw, tw = partition_workers(runs["td"].x_train, runs["td"].t_train, M)
    with pytest.raises(ValueError, match="exactly one"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg)
    with pytest.raises(ValueError, match="exactly one"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, torch.Generator(), r=r)
    with pytest.raises(ValueError, match="shapes"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, r=r[:2])
    with pytest.raises(ValueError, match="exactly one"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, torch.Generator(), key=prng.PRNGKey(1))
    with pytest.raises(ValueError, match="PRNG key"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, r=r, checkpoint_dir="/nowhere")


def test_facade_trains_like_the_loop(runs):
    spec = dssfn.TrainSpec(cfg=runs["cfg"], workers=M, policy="exact")
    xw, tw = spec.partition_data(runs["td"].x_train, runs["td"].t_train)
    res = dssfn.train(spec, xw, tw, r=runs["r"])
    want_p, want_log = runs["torch"]["dec"]
    assert all(torch.equal(a, b) for a, b in zip(res.params.o, want_p.o))
    assert res.log.comm_scalars == want_log.comm_scalars
    assert res.policy == ExactMean() and res.backend.num_workers == M
    acc = dssfn.evaluate(res, runs["td"].x_test, runs["td"].y_test)
    assert acc == pytest.approx(layerwise.accuracy(
        runs["torch"]["dec"][0], runs["td"].x_test, runs["td"].y_test, 4))
    jspec = jdssfn.TrainSpec(cfg=js.SSFNConfig(**GEOM), workers=M)
    assert {f.name for f in dataclasses.fields(spec)} == {
        f.name for f in dataclasses.fields(jspec)}


#: The fields that once raised NotImplementedError (ROADMAP Queue 1 item
#: 5); "group" stands for a one-rank CPU worker group holding all M.
UNPORTED = [
    dict(backend="mesh"),
    dict(mesh="group"),
]


def _train_both(runs, policy, **geom):
    jspec = jdssfn.TrainSpec(cfg=js.SSFNConfig(**{**GEOM, **geom}), workers=M, policy=policy)
    jres = jdssfn.train(jspec, *jspec.partition_data(runs["data"].x_train, runs["data"].t_train),
                        jax.random.PRNGKey(1))
    spec = dssfn.TrainSpec(cfg=dataclasses.replace(runs["cfg"], **geom), workers=M, policy=policy)
    res = dssfn.train(spec, *spec.partition_data(runs["td"].x_train, runs["td"].t_train),
                      r=runs["r"])
    assert res.policy.describe() == jres.policy.describe()
    assert res.policy.wire_bits == jres.policy.wire_bits
    assert res.log.comm_scalars == jres.log.comm_scalars
    return res, jres


@pytest.mark.parametrize("policy", ["lossy:0.1:6:1", "lossy:0.2:2@ring:1", "stale:2",
                                    "stale:3", "stale:2@full"])
def test_facade_trains_lossy_and_stale_like_reference(runs, policy):
    """Their draws are repro's and their arithmetic has no rounding step
    that an ulp can flip, so they hold to the ADMM readout bar (measured
    at most 7.0e-6 at layer 3)."""
    res, jres = _train_both(runs, policy)
    for l, (a, b) in enumerate(zip(res.params.o, jres.params.o)):
        assert _rel(a.numpy(), b) <= GAP, l
    np.testing.assert_allclose(res.log.layer_costs, jres.log.layer_costs, rtol=GAP)
    exact = runs["torch"]["dec"][0]
    assert min(_rel(a.numpy(), b.numpy()) for a, b in zip(res.params.o, exact.o)) > 1e-3


@pytest.mark.parametrize("policy,iters", [("async:interval=2:rounds=2", 30),
                                          ("trimmed:f=1:attack=signflip", 30),
                                          ("async:interval=4", 28)])
def test_facade_trains_async_and_robust_like_reference(runs, policy, iters):
    """The communication interval and the trimmed screen against one
    attacker (worker 0 sends -x): no rounding step an ulp can flip, and no
    screen decision flipped at this geometry, so each layer holds to the
    ADMM readout bar (measured at most 8.6e-6 at layer 3).  An interval
    must divide K: at K=30 interval 4 refuses in both packages alike."""
    if iters != GEOM["admm_iters"]:
        spec = dssfn.TrainSpec(cfg=runs["cfg"], workers=M, policy=policy)
        with pytest.raises(ValueError) as e:
            dssfn.train(spec, *spec.partition_data(runs["td"].x_train, runs["td"].t_train),
                        r=runs["r"])
        with pytest.raises(ValueError) as je:
            jspec = jdssfn.TrainSpec(cfg=js.SSFNConfig(**GEOM), workers=M, policy=policy)
            jdssfn.train(jspec, *jspec.partition_data(runs["data"].x_train,
                                                      runs["data"].t_train), jax.random.PRNGKey(1))
        assert str(e.value) == str(je.value)
    res, jres = _train_both(runs, policy, admm_iters=iters)
    for l, (a, b) in enumerate(zip(res.params.o, jres.params.o)):
        assert _rel(a.numpy(), b) <= GAP, l
    np.testing.assert_allclose(res.log.layer_costs, jres.log.layer_costs, rtol=GAP)
    exact = runs["torch"]["dec"][0]
    assert min(_rel(a.numpy(), b.numpy()) for a, b in zip(res.params.o, exact.o)) > 1e-3


#: Stochastic rounding turns an f32 ulp of difference between the
#: packages' Grams into a flipped rounding (one quantization step, 1/255
#: of a worker's range at 8 bits), and the ADMM iterations and later
#: layers carry the flips.  Layer 0 sees the same data in both packages,
#: so its draws and readout agree (measured 9.0e-7); layers 1-3 were
#: measured 1.0e-2, 4.1e-2, 4.4e-2 from repro's, about the policy's own
#: effect (2.3e-2 to 6.2e-2 against ExactMean, in either package).
QUANT_GAP = 0.1


def test_facade_trains_quantized_like_reference(runs):
    res, jres = _train_both(runs, "quantized:8")
    assert _rel(res.params.o[0].numpy(), jres.params.o[0]) <= GAP
    for l, (a, b) in enumerate(zip(res.params.o[1:], jres.params.o[1:]), 1):
        assert _rel(a.numpy(), b) <= QUANT_GAP, l
    exact = runs["torch"]["dec"][0]
    assert _rel(res.params.o[0].numpy(), exact.o[0].numpy()) > 100 * GAP
    x = runs["data"].x_test
    acc = dssfn.evaluate(res, runs["td"].x_test, runs["td"].y_test)
    jacc = jdssfn.evaluate(jres, x, runs["data"].y_test)
    assert abs(acc - jacc) <= 0.05


def _unported_id(kw):
    key, value = next(iter(kw.items()))
    return f"policy={value}" if key == "policy" else key


@pytest.mark.parametrize("kw", UNPORTED, ids=_unported_id)
def test_train_spec_rejects_unported_fields(runs, kw):
    """``backend="mesh"`` and ``mesh=`` now train: a one-rank CPU group
    holding all M workers gives the simulated run's readouts within 1e-4
    (its reductions sum in another order) and the same eq.-15 scalars; a
    ``mesh`` that is no worker group is refused."""
    from repro_torch.core.backend import MeshBackend
    from repro_torch.launch.mesh import make_worker_group

    group = make_worker_group(M, device="cpu")
    spec = dssfn.TrainSpec(cfg=runs["cfg"], workers=M, backend="mesh", mesh=group)
    xw, tw = spec.partition_data(runs["td"].x_train, runs["td"].t_train)
    res = dssfn.train(spec, xw, tw, r=runs["r"])
    want_p, want_log = runs["torch"]["dec"]
    assert isinstance(res.backend, MeshBackend) and res.backend.group is group
    assert res.log.comm_scalars == want_log.comm_scalars
    for a, b, c in zip(res.params.o, want_p.o, runs["jax"]["dec"][0].o):
        assert _rel(a.numpy(), b.numpy()) <= GAP
        assert _rel(a.numpy(), c) <= GAP
    with pytest.raises(TypeError, match="WorkerGroup"):
        dssfn.TrainSpec(cfg=runs["cfg"], workers=M, backend="mesh", mesh=object())


#: The elastic-training fields, each trained alone (checkpoint_dir set
#: wherever the field needs one).
ELASTIC = [
    dict(checkpoint_dir=True),
    dict(checkpoint_every=2),
    dict(resume=True),
    dict(stop_after_layer=1),
    dict(guard_divergence=True),
    dict(max_rollbacks=3),
]


@pytest.mark.parametrize("kw", ELASTIC, ids=lambda kw: next(iter(kw)))
def test_train_spec_trains_elastic_fields_like_reference(runs, kw, tmp_path):
    """Each field trains in both packages from the same data, R and key:
    readouts within the readout bar, the same checkpoint files."""
    dirs = {}
    if set(kw) & {"checkpoint_dir", "checkpoint_every", "resume"}:
        dirs = {"port": str(tmp_path / "port"), "repro": str(tmp_path / "repro")}
    jspec = jdssfn.TrainSpec(cfg=js.SSFNConfig(**GEOM), workers=M,
                             **{**kw, "checkpoint_dir": dirs.get("repro")})
    jres = jdssfn.train(jspec, *jspec.partition_data(runs["data"].x_train, runs["data"].t_train),
                        jax.random.PRNGKey(1))
    spec = dssfn.TrainSpec(cfg=runs["cfg"], workers=M, **{**kw, "checkpoint_dir": dirs.get("port")})
    res = dssfn.train(spec, *spec.partition_data(runs["td"].x_train, runs["td"].t_train),
                      r=runs["r"], key=prng.PRNGKey(1))
    assert len(res.params.o) == len(jres.params.o) == (2 if "stop_after_layer" in kw else 4)
    for l, (a, b) in enumerate(zip(res.params.o, jres.params.o)):
        assert _rel(a.numpy(), b) <= GAP, l
    assert res.log.rollbacks == jres.log.rollbacks == 0
    assert res.log.comm_scalars == jres.log.comm_scalars
    if dirs:
        assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["repro"]))
        assert os.listdir(dirs["port"])


def test_train_spec_rejects_unknown_backend(runs):
    with pytest.raises(ValueError, match="unknown backend"):
        dssfn.TrainSpec(cfg=runs["cfg"], workers=M, backend="cluster")
