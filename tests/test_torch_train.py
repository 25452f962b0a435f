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
from repro_torch import dssfn
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
    with pytest.raises(TypeError):
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


UNPORTED = [
    dict(backend="mesh"),
    dict(mesh=object()),
    dict(policy="gossip:4:2"),
    dict(topology="ring:2"),
    dict(membership="1101"),
    dict(wire_dtype="bf16"),
    dict(checkpoint_dir="/tmp/ckpt"),
    dict(checkpoint_every=2),
    dict(resume=True),
    dict(stop_after_layer=1),
    dict(guard_divergence=True),
    dict(max_rollbacks=3),
]


@pytest.mark.parametrize("kw", UNPORTED, ids=lambda kw: next(iter(kw)))
def test_train_spec_rejects_unported_fields(runs, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        dssfn.TrainSpec(cfg=runs["cfg"], workers=M, **kw)


def test_train_spec_rejects_unknown_backend(runs):
    with pytest.raises(ValueError, match="unknown backend"):
        dssfn.TrainSpec(cfg=runs["cfg"], workers=M, backend="cluster")
