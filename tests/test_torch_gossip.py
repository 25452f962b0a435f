"""The port's gossip against repro's: primitives, policies, the spec
grammar, ADMM, the layer loop, the facade and the launcher.

Bars:

- Mixes (``schedule_gossip_step``/``_average``, ``ring_gossip_average``,
  ``gossip_average``, ``Gossip.mix``): within 1e-6 x max|x| of the
  reference on the same f32 input.  Both packages add the same terms in
  the same order, so they differ only where XLA rewrites the arithmetic:
  it divides by the uniform schedule's term count as a multiply by its
  reciprocal, an ulp per round.  Inside the port the uniform serial path
  is bit-identical to ``ring_gossip_average``.
- The spec grammar: every entry of ``repro.analysis.grammar.ALL_GRAMMAR``
  gives a policy whose ``describe()``, ``wire_bits``, eq.-15 counts and
  hop counts equal the reference's, and every ``MALFORMED_SPECS`` entry
  refuses with the reference's message.
- ADMM and training: the bars of ``tests/test_torch_admm.py`` and
  ``tests/test_torch_train.py`` (readouts within a relative gap of
  1e-4, traces rtol 1e-4, counts equal).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dssfn as jdssfn
from repro.analysis.grammar import ALL_GRAMMAR, MALFORMED_SPECS
from repro.core import admm as jadmm
from repro.core import consensus as jc
from repro.core import layerwise as jl
from repro.core import policy as jp
from repro.core import ssfn as js
from repro.core import topology as jt
from repro.core.backend import SimulatedBackend as JBackend
from repro.data import make_classification as j_make
from repro.data import partition_workers as j_part
from repro_torch import dssfn
from repro_torch.convert import dataset_from_numpy, r_from_numpy
from repro_torch.core import admm, layerwise, ssfn
from repro_torch.core import consensus as tc
from repro_torch.core import policy as tp
from repro_torch.core import topology as tt
from repro_torch.core.backend import SimulatedBackend
from repro_torch.data import partition_workers
from repro_torch.launch import train_dssfn

MIX_TOL = 1e-6
GAP = 1e-4
# A bf16 wire rounds every message to 8 significant bits, so an f32 ulp
# of difference between the packages' Grams can flip a message's rounding
# by one bf16 ulp, 2**-7 of its size, and the ADMM iterations and later
# layers carry such flips into the readouts: a bf16-wire train is held to
# 2**-7 of each readout (measured: 9e-4 at layer 0, 4.7e-3 at layer 3).
# That is about the wire's own effect on a readout (4-7e-3 in both
# packages), so the test also requires the port's bf16 readouts to move
# from its f32 ones; each bf16 mix is held to MIX_TOL above.
BF16_GAP = 2.0**-7
ADMMTRACE_FIELDS = ("objective", "primal_residual", "dual_residual")
WIRES = [None, "bfloat16", "float16"]


def _x(m, seed=0, shape=(3, 5)):
    return np.random.default_rng(seed).standard_normal((m, *shape)).astype(np.float32)


def _close(got, want, x):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = np.abs(got.astype(np.float64) - np.asarray(want, np.float64)).max()
    assert err <= MIX_TOL * np.abs(x).max(), err


def _spmd(fn, *xs):
    """``fn`` per worker under the reference's vmap SPMD semantics."""
    return np.asarray(jax.vmap(fn, axis_name="w")(*map(jnp.asarray, xs)))


def _jmix(policy, x):
    ctx = jp.ConsensusContext("w", x.shape[0])
    return _spmd(lambda xi: policy.mix(xi, policy.init_state(xi, ctx), ctx)[0], x)


def _tmix(policy, x):
    ctx = tp.ConsensusContext(x.shape[0])
    out, _ = policy.mix(torch.from_numpy(x), policy.init_state(None, ctx), ctx)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _schedules(t):
    """A uniform schedule (the degree-2 ring) and two weighted ones (a
    Birkhoff-compiled power of it and a Metropolis geometric graph)."""
    return {
        "uniform": t.Ring(2).exchange_schedule(6),
        "power": t.Ring(2).power_schedule(6, 3),
        "geometric": t.RandomGeometric(0.5, seed=1).exchange_schedule(6),
    }


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("kind", ["uniform", "power", "geometric"])
@pytest.mark.parametrize("self_value", [False, True])
def test_schedule_gossip_step_matches_reference(kind, wire, self_value):
    x, s = _x(6, seed=1), _x(6, seed=2)
    t_sched, j_sched = _schedules(tt)[kind], _schedules(jt)[kind]
    if self_value:
        want = _spmd(lambda xi, si: jc.schedule_gossip_step(
            xi, "w", j_sched, self_value=si, wire_dtype=wire), x, s)
        got = tc.schedule_gossip_step(torch.from_numpy(x), t_sched,
                                      self_value=torch.from_numpy(s), wire_dtype=wire)
    else:
        want = _spmd(lambda xi: jc.schedule_gossip_step(xi, "w", j_sched, wire_dtype=wire), x)
        got = tc.schedule_gossip_step(torch.from_numpy(x), t_sched, wire_dtype=wire)
    assert got.dtype == torch.float32
    _close(got, want, np.maximum(np.abs(x), np.abs(s)))


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("kind", ["uniform", "power"])
def test_schedule_gossip_average_matches_reference(kind, wire):
    x = _x(6, seed=3)
    t_sched, j_sched = _schedules(tt)[kind], _schedules(jt)[kind]
    want = _spmd(lambda xi: jc.schedule_gossip_average(xi, "w", j_sched, 4, wire_dtype=wire), x)
    _close(tc.schedule_gossip_average(torch.from_numpy(x), t_sched, 4, wire_dtype=wire), want, x)


def test_narrow_wire_takes_the_weighted_form_and_keeps_own_value_wide():
    """A bf16 wire casts the payload once and accumulates in f32; a
    torch.float32 input with wire "float32" stays on the uniform path."""
    x = torch.from_numpy(_x(6, seed=4))
    sched = tt.Ring(1).exchange_schedule(6)
    wide = tc.schedule_gossip_step(x, sched, wire_dtype="float32")
    assert torch.equal(wide, tc.schedule_gossip_step(x, sched))
    assert torch.equal(wide, tc.ring_gossip_step(x, 1, 6))
    narrow = tc.schedule_gossip_step(x, sched, wire_dtype="bf16")
    w = sched.self_weight
    want = w * x
    for perm, wk in zip(sched.perms, sched.weights):
        want = want + wk * tc.ppermute(x.to(torch.bfloat16), perm).float()
    assert torch.equal(narrow, want) and not torch.equal(narrow, wide)
    with pytest.raises(ValueError, match="unknown wire dtype"):
        tc.schedule_gossip_step(x, sched, wire_dtype="int8")


def test_ppermute_follows_pair_lists():
    x = torch.arange(4.0)[:, None]
    assert tc.ppermute(x, ((0, 1), (1, 2), (2, 3), (3, 0))).flatten().tolist() == [3, 0, 1, 2]
    want = _spmd(lambda xi: jax.lax.ppermute(xi, "w", ((0, 2), (1, 0), (2, 3), (3, 1))),
                 x.numpy())
    got = tp.ConsensusContext(4).ppermute(x, ((0, 2), (1, 0), (2, 3), (3, 1)))
    assert np.array_equal(got.numpy(), want)
    # Every schedule hop permutes the workers; a pair list that does not
    # is refused (the reference's vmap form refuses it too).
    for bad in [((0, 2), (3, 1)), ((0, 1), (1, 1), (2, 3), (3, 0))]:
        with pytest.raises(ValueError, match="does not permute"):
            tp.ConsensusContext(4).ppermute(x, bad)


@pytest.mark.parametrize("degree,rounds", [(1, 1), (2, 5), (3, 4)])
def test_ring_gossip_average_matches_reference(degree, rounds):
    x = _x(8, seed=5)
    want = _spmd(lambda xi: jc.ring_gossip_average(xi, "w", degree, 8, rounds), x)
    got = tc.ring_gossip_average(torch.from_numpy(x), degree, 8, rounds)
    _close(got, want, x)
    serial = _tmix(tp.RingGossip(rounds, degree, compress=False), x)
    assert torch.equal(serial, got)          # the uniform serial path, bit for bit


@pytest.mark.parametrize("rounds", [1, 7])
def test_dense_gossip_and_error_match_reference(rounds):
    x = _x(5, seed=6)
    h = jt.circular_mixing_matrix(5, 1)
    want = np.asarray(jc.gossip_average(jnp.asarray(x), h, rounds))
    _close(tc.gossip_average(torch.from_numpy(x), h, rounds), want, x)
    err = float(tc.gossip_error(torch.from_numpy(x)))
    assert abs(err - float(jc.gossip_error(jnp.asarray(x)))) <= MIX_TOL * np.abs(x).max()
    _close(tc.exact_average(torch.from_numpy(x)), np.asarray(jc.exact_average(jnp.asarray(x))), x)


def test_make_consensus_fn_warns_and_builds_like_reference():
    x = _x(5, seed=7)
    h = jt.circular_mixing_matrix(5, 2)
    with pytest.warns(DeprecationWarning, match="ConsensusPolicy"):
        fn = tc.make_consensus_fn("gossip", h=h, num_rounds=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jfn = jc.make_consensus_fn("gossip", h=h, num_rounds=3)
        assert tc.make_consensus_fn("exact") is tc.exact_average
        for bad in [dict(mode="gossip"), dict(mode="median")]:
            with pytest.raises(ValueError) as je:
                jc.make_consensus_fn(**bad)
            with pytest.raises(ValueError, match=str(je.value)):
                tc.make_consensus_fn(**bad)
    _close(fn(torch.from_numpy(x)), np.asarray(jfn(jnp.asarray(x))), x)
    want = np.linalg.matrix_power(h, 3) @ x.reshape(5, -1).astype(np.float64)
    _close(fn(torch.from_numpy(x)), want.reshape(x.shape), x)


# ---------------------------------------------------------------------------
# Gossip.mix
# ---------------------------------------------------------------------------


#: (name, M, factory over the topology module)
GRAPHS = [
    ("ring", 7, lambda t: t.Ring(2)),
    ("torus", 8, lambda t: t.Torus(2, 4)),
    ("hypercube", 8, lambda t: t.Hypercube()),
    ("timevarying", 8, lambda t: t.TimeVarying((t.Ring(1), t.Hypercube()))),
    ("masked", 8, lambda t: t.Masked(t.Torus(2, 4), t.Membership((1, 1, 0, 1, 1, 1, 0, 1)))),
]


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,m,build", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_gossip_mix_matches_reference(name, m, build, compress, wire):
    x = _x(m, seed=8)
    mine = tp.Gossip(rounds=3, topology=build(tt), compress=compress, wire_dtype=wire)
    ref = jp.Gossip(rounds=3, topology=build(jt), compress=compress, wire_dtype=wire)
    _close(_tmix(mine, x), _jmix(ref, x), x)
    assert mine.hops_for(m) == ref.hops_for(m)
    assert mine.exchanges_for(m) == ref.exchanges_for(m)
    assert mine.wire_bits == ref.wire_bits and mine.describe() == ref.describe()
    assert mine == tp.Gossip(rounds=3, topology=build(tt), compress=compress,
                             wire_dtype=wire)
    assert hash(mine) == hash(tp.Gossip(rounds=3, topology=build(tt),
                                        compress=compress, wire_dtype=wire))


def test_the_papers_gossip_compresses_to_19_hops():
    """RingGossip(52, 4) over M=20: 416 serial hops compress to 19, and
    one mix is H^52 x within the f32 bar."""
    x = _x(20, seed=9, shape=(2, 7))
    pol = tp.RingGossip(52, 4)
    assert pol.hops_for(20) == jp.RingGossip(52, 4).hops_for(20) == 19
    assert tp.RingGossip(52, 4, compress=False).hops_for(20) == 416
    assert pol.exchanges_for(20) == 416
    h52 = np.linalg.matrix_power(tt.circular_mixing_matrix(20, 4), 52)
    _close(_tmix(pol, x), (h52 @ x.reshape(20, -1).astype(np.float64)).reshape(x.shape), x)
    _close(_tmix(pol, x), _jmix(jp.RingGossip(52, 4), x), x)


def test_gossip_refuses_like_reference():
    for build in [
        lambda p, t: p.Gossip(rounds=0),
        lambda p, t: p.Gossip(topology="ring"),
        lambda p, t: p.Gossip(wire_dtype="int8"),
        lambda p, t: p.RingGossip(1, 3).validate(6),
        lambda p, t: p.Gossip(topology=t.Torus(2, 3)).validate(8),
    ]:
        with pytest.raises((ValueError, TypeError)) as e:
            build(tp, tt)
        with pytest.raises(type(e.value)) as je:
            build(jp, jt)
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# the spec grammar
# ---------------------------------------------------------------------------


PORTED = [e.spec for e in ALL_GRAMMAR]


@pytest.mark.parametrize("spec", PORTED)
def test_parse_spec_matches_reference(spec):
    mine, ref = dssfn.parse_spec(spec), jdssfn.parse_spec(spec)
    assert mine.describe() == ref.describe() and mine.wire_bits == ref.wire_bits
    assert mine.exchanges_for(8) == ref.exchanges_for(8)
    assert mine.comm_scalars(scalars=40, num_consensus=30, num_workers=8) == \
        ref.comm_scalars(scalars=40, num_consensus=30, num_workers=8)
    assert mine.wire_bytes(scalars=40, num_consensus=30, num_workers=8) == \
        ref.wire_bytes(scalars=40, num_consensus=30, num_workers=8)
    if hasattr(ref, "hops_for"):
        assert mine.hops_for(8) == ref.hops_for(8)


@pytest.mark.parametrize("spec,fragment", MALFORMED_SPECS, ids=[s for s, _ in MALFORMED_SPECS])
def test_malformed_specs_refuse_like_reference(spec, fragment):
    """Refused at parse time or, like a time-varying StaleMixing, by
    ``validate(M)``: both stages run, as the reference's own test does."""
    with pytest.raises(ValueError) as je:
        jdssfn.parse_spec(spec).validate(8)
    with pytest.raises(ValueError) as e:
        dssfn.parse_spec(spec).validate(8)
    assert fragment in str(e.value) and str(e.value) == str(je.value)


@pytest.mark.parametrize("spec", ["async:interval=x", "trimmed:f=1.5", "clipped:abc",
                                  "async:fail=1+x", "median:drop=y", "lossy:p",
                                  "lossy:0.1:2:x", "quantized:x", "stale:1.5", "gossip:2:x",
                                  "gossip:x@torus:2x4"])
def test_unparsable_segments_refuse_like_reference(spec):
    """A segment that does not parse is a ValueError in every policy,
    ported or not, with the reference's message."""
    with pytest.raises(ValueError) as je:
        jdssfn.parse_spec(spec)
    with pytest.raises(ValueError) as e:
        dssfn.parse_spec(spec)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("spec,kw", [
    ("gossip", dict(degree=2, rounds=5)), ("gossip:3", dict(topology="hypercube")),
    ("gossip:2", dict(topology=jt.Torus(2, 4))), ("gossip:1:wire=f16", {}),
])
def test_parse_policy_fallbacks_match_reference(spec, kw):
    tkw = dict(kw)
    if isinstance(kw.get("topology"), jt.Topology):
        tkw["topology"] = tt.Torus(2, 4)
    assert tp.parse_policy(spec, **tkw).describe() == jp.parse_policy(spec, **kw).describe()
    with pytest.raises(ValueError, match="drop one of them"):
        tp.parse_policy("gossip@ring:2", topology="ring:1")


# ---------------------------------------------------------------------------
# ADMM, the layer loop, the facade and the launcher
# ---------------------------------------------------------------------------


def _problem(n, q, j, m, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, j)).astype(np.float32)
    t = rng.standard_normal((q, j)).astype(np.float32)
    yw = np.ascontiguousarray(y.reshape(n, m, j // m).transpose(1, 0, 2))
    tw = np.ascontiguousarray(t.reshape(q, m, j // m).transpose(1, 0, 2))
    return yw, tw


def _same_admm(res, jres):
    assert _rel(res.o_star.numpy(), jres.o_star) <= GAP
    assert _rel(res.o_workers.numpy(), jres.o_workers) <= GAP
    for field in ADMMTRACE_FIELDS:
        g, w = getattr(res.trace, field).numpy(), np.asarray(getattr(jres.trace, field))
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    # The consensus error max|mix - mean| is a difference of nearly equal
    # values: each mix holds to MIX_TOL of the mixed values' size, so the
    # error does to twice that.
    mixed = np.abs(np.asarray(jres.o_workers) + np.asarray(jres.lam)).max()
    np.testing.assert_allclose(res.trace.consensus_error.numpy(),
                               np.asarray(jres.trace.consensus_error),
                               rtol=1e-4, atol=2 * MIX_TOL * mixed)


def test_admm_under_ring_gossip_matches_reference():
    yw, tw = _problem(16, 3, 240, 6, seed=10)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=60)
    res = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                    backend=SimulatedBackend(6, policy=tp.RingGossip(6, 2)), **kw)
    jres = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw),
                                      backend=JBackend(6, policy=jp.RingGossip(6, 2)), **kw)
    _same_admm(res, jres)
    assert float(res.trace.consensus_error[-1]) > 0          # gossip is not exact


def test_admm_under_consensus_fn_matches_reference():
    yw, tw = _problem(16, 3, 240, 6, seed=11)
    h = jt.circular_mixing_matrix(6, 1)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=60)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn = tc.make_consensus_fn("gossip", h=h, num_rounds=4)
        jfn = jc.make_consensus_fn("gossip", h=h, num_rounds=4)
    res = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                    consensus_fn=fn, **kw)
    jres = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), consensus_fn=jfn, **kw)
    assert res.o_star.shape == (3, 16) and res.trace.objective.shape == (60,)
    _same_admm(res, jres)
    np.testing.assert_array_equal(res.jitter.numpy(), np.asarray(jres.jitter))
    y, t = torch.from_numpy(yw), torch.from_numpy(tw)
    with pytest.raises(ValueError, match="not both"):
        admm.admm_ridge_consensus(y, t, consensus_fn=fn, policy=tp.ExactMean(), **kw)
    with pytest.raises(ValueError, match="always traces"):
        admm.admm_ridge_consensus(y, t, consensus_fn=fn, trace_every=0, **kw)


GEOM = dict(input_dim=32, num_classes=4, num_layers=3, hidden=128,
            mu0=1e-1, mul=1e-1, admm_iters=30)
M = 4


@pytest.fixture(scope="module")
def problem():
    data = j_make(jax.random.PRNGKey(0), num_train=1024, num_test=256,
                  input_dim=32, num_classes=4)
    jcfg = js.SSFNConfig(**GEOM)
    key = jax.random.PRNGKey(1)
    r = [np.asarray(a) for a in js.init_random_matrices(key, jcfg)]
    td = dataset_from_numpy(data, device="cpu")
    return dict(data=data, td=td, key=key, jcfg=jcfg, cfg=ssfn.SSFNConfig(**GEOM),
                r=r_from_numpy(r, device="cpu"))


def _same_train(params, log, jparams, jlog, problem, gap=GAP):
    assert len(params.o) == len(jparams.o) == GEOM["num_layers"] + 1
    for l, (a, b) in enumerate(zip(params.o, jparams.o)):
        assert _rel(a.numpy(), b) <= gap, l
    want = np.asarray(js.predict(jparams, problem["data"].x_test, 4))
    got = ssfn.predict(params, problem["td"].x_test, 4).numpy()
    assert _rel(got, want) <= gap
    assert (got.argmax(0) == want.argmax(0)).mean() >= 0.99
    assert log.comm_scalars == jlog.comm_scalars
    np.testing.assert_allclose(log.layer_costs, jlog.layer_costs, rtol=gap)
    np.testing.assert_allclose(log.admm_objective, np.asarray(jlog.admm_objective), rtol=gap)


@pytest.mark.parametrize("kw", [
    dict(policy="gossip:6:1"),
    dict(topology="torus:2x2", membership="1101"),
    dict(policy="gossip:6:1", wire_dtype="bf16"),
], ids=["gossip", "torus-membership", "bf16-wire"])
def test_facade_trains_gossip_like_reference(problem, kw):
    jspec = jdssfn.TrainSpec(cfg=problem["jcfg"], workers=M, **kw)
    jxw, jtw = jspec.partition_data(problem["data"].x_train, problem["data"].t_train)
    jres = jdssfn.train(jspec, jxw, jtw, problem["key"])
    spec = dssfn.TrainSpec(cfg=problem["cfg"], workers=M, **kw)
    xw, tw = spec.partition_data(problem["td"].x_train, problem["td"].t_train)
    res = dssfn.train(spec, xw, tw, r=problem["r"])
    assert res.policy.describe() == jres.policy.describe()
    assert res.policy.wire_bits == jres.policy.wire_bits
    if "wire_dtype" not in kw:
        _same_train(res.params, res.log, jres.params, jres.log, problem)
        return
    _same_train(res.params, res.log, jres.params, jres.log, problem, gap=BF16_GAP)
    wide = dssfn.train(dssfn.TrainSpec(cfg=problem["cfg"], workers=M, policy=kw["policy"]),
                       xw, tw, r=problem["r"])
    assert min(_rel(a.numpy(), b.numpy()) for a, b in zip(res.params.o, wide.params.o)) > 1e-3


def test_legacy_consensus_fn_train_matches_reference(problem):
    h = jt.circular_mixing_matrix(M, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        fn = tc.make_consensus_fn("gossip", h=h, num_rounds=8)
        jfn = jc.make_consensus_fn("gossip", h=h, num_rounds=8)
    jxw, jtw = j_part(problem["data"].x_train, problem["data"].t_train, M)
    jparams, jlog = jl.train_decentralized_ssfn(jxw, jtw, problem["jcfg"], problem["key"],
                                                consensus_fn=jfn, gossip_rounds=8)
    xw, tw = partition_workers(problem["td"].x_train, problem["td"].t_train, M)
    params, log = layerwise.train_decentralized_ssfn(xw, tw, problem["cfg"], r=problem["r"],
                                                     consensus_fn=fn, gossip_rounds=8)
    _same_train(params, log, jparams, jlog, problem)
    assert log.admm_objective.shape == (4, 30) and log.jitter_levels.shape == (0, 0)
    with pytest.raises(ValueError, match="not both"):
        layerwise.train_decentralized_ssfn(xw, tw, problem["cfg"], r=problem["r"],
                                           consensus_fn=fn, policy=tp.ExactMean())
    with pytest.raises(ValueError, match="always traces"):
        layerwise.train_decentralized_ssfn(xw, tw, problem["cfg"], r=problem["r"],
                                           consensus_fn=fn, trace_every=0)


def test_spec_resolution_matches_reference(problem):
    for kw in [dict(topology="hypercube"), dict(policy="gossip:2@ring:1"),
               dict(policy=tp.RingGossip(3, 1), topology="ring:1+hypercube"),
               dict(policy="gossip:2", wire_dtype="f16", membership="1011")]:
        jkw = dict(kw)
        if isinstance(kw.get("policy"), tp.Gossip):
            jkw["policy"] = jp.RingGossip(3, 1)
        got = dssfn.TrainSpec(cfg=problem["cfg"], workers=M, **kw).resolve_policy()
        want = jdssfn.TrainSpec(cfg=problem["jcfg"], workers=M, **jkw).resolve_policy()
        assert got.describe() == want.describe()
    for kw, match in [(dict(policy="gossip@ring:1", topology="ring:1"), "drop spec.topology"),
                      (dict(wire_dtype="bf16"), "does not take a wire_dtype"),
                      (dict(membership="1101"), "cannot mask"),
                      (dict(policy="exact", topology="ring:1"), "takes no topology")]:
        with pytest.raises(ValueError, match=match):
            dssfn.TrainSpec(cfg=problem["cfg"], workers=M, **kw)


LAUNCH = ["--device", "cpu", "--layers", "2", "--hidden", "40", "--admm-iters", "20",
          "--train", "480", "--test", "120"]


@pytest.mark.parametrize("argv,workers,want", [
    (["--consensus", "gossip:4:2", "--workers", "5"], 5, jp.RingGossip(4, 2)),
    (["--topology", "ring:1", "--rounds", "3", "--workers", "4"], 4,
     jp.Gossip(3, jt.Ring(1))),
    (["--topology", "torus:2x2", "--membership", "1101", "--rounds", "2", "--workers", "4"],
     4, jp.Gossip(2, jt.Masked(jt.Torus(2, 2), jt.Membership((1, 1, 0, 1))))),
], ids=["gossip:4:2", "topology-ring:1", "torus-membership"])
def test_launcher_trains_gossip_on_cpu(argv, workers, want):
    res = train_dssfn.main(LAUNCH + argv)
    run = res["runs"][0]
    assert res["device"] == "cpu" and run["policy"] == want.describe()
    assert run["wire_bits"] == want.wire_bits == 32
    # Eq. 15: Q (n_0 + L n) scalars x K iterations x the policy's exchanges.
    assert run["comm_scalars"] == 6 * (16 + 40 + 40) * 20 * want.exchanges_for(workers)
    assert 0.0 <= run["test_accuracy"] <= 1.0 and run["final_objective"] > 0
    assert len(run["consensus_error"]) == 3 and max(run["consensus_error"]) > 0
    topo = train_dssfn.build_policy(train_dssfn.parse_args(argv)).topology
    assert res["topology"] == {
        "spec": topo.describe(), "spectral_gap": topo.spectral_gap(workers),
        "edges_per_node": topo.edges_per_node(workers),
        "rounds_for_tolerance_1e6": topo.rounds_for_tolerance(workers, 1e-6)}


def test_launcher_policy_flags_match_reference():
    from repro.launch import train_dssfn as jlaunch

    for argv in [["--consensus", "gossip"], ["--consensus", "gossip", "--degree", "1"],
                 ["--topology", "torus:2x4"], ["--consensus", "gossip:3@hypercube"],
                 ["--consensus", "gossip:3", "--no-compress"],
                 ["--consensus", "gossip:2:1", "--wire-dtype", "bf16"]]:
        got = train_dssfn.build_policy(train_dssfn.parse_args(argv))
        assert got.describe() == jlaunch.build_policy(jlaunch.parse_args(argv)).describe()
    for argv, match in [(["--topology", "ring:1", "--degree", "2"], "not both"),
                        (["--consensus", "gossip@ring:1", "--topology", "ring:2"],
                         "drop --topology")]:
        with pytest.raises(ValueError, match=match):
            train_dssfn.build_policy(train_dssfn.parse_args(argv))
