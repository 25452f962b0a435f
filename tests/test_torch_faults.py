"""The port's fault model and asynchronous gossip against repro's:
``FaultModel``, ``faulty_schedule_gossip_step``, ``AsyncGossip`` mix by
mix, the communication interval of the ADMM loop, and the spec grammar.

Bars:

- Up-masks: ``FaultModel.alive_mask`` equals repro's bit for bit (the
  same threefry words, drawn on the host).
- Mixes: within MIX_TOL = 1e-6 x max|x| of repro's on the same f32
  input, over three consecutive mixes that carry the state (the call
  count, the straggler and replay buffers, which must equal repro's).
  Both packages add the same terms in the same order; they differ only
  where XLA divides a uniform round by a multiply with the reciprocal (an
  ulp a round; ROADMAP Queue 3).  Inside the port a null fault model is
  bit-identical to ``Gossip(compress=False)``.
- ADMM: the readout within a relative 1e-4 of repro's and the
  per-iteration traces within rtol 1e-4, interval chunks included.
- Validation errors: the reference's messages, word for word.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import admm as jadmm
from repro.core import consensus as jc
from repro.core import engine as jengine
from repro.core import policy as jp
from repro.core import topology as jt
from repro.core.backend import SimulatedBackend as JBackend
from repro_torch.core import admm, engine
from repro_torch.core import consensus as tc
from repro_torch.core import policy as tp
from repro_torch.core import topology as tt
from repro_torch.core.backend import SimulatedBackend

MIX_TOL = 1e-6
GAP = 1e-4


def _x(m, seed, shape=(3, 5)):
    return np.random.default_rng(seed).standard_normal((m, *shape)).astype(np.float32)


def _close(got, want, x, tol=MIX_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64)).max(initial=0.0)
    assert err <= tol * np.abs(x).max(), err


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jmixes(policy, xs):
    """repro's mixes of ``xs`` in turn, the state carried, under vmap;
    returns the outputs and the final state."""
    ctx = jp.ConsensusContext("w", xs[0].shape[0])

    def body(*xis):
        state = policy.init_state(xis[0], ctx)
        outs = []
        for xi in xis:
            y, state = policy.mix(xi, state, ctx)
            outs.append(y)
        return tuple(outs), state

    outs, state = jax.vmap(body, axis_name="w")(*map(jnp.asarray, xs))
    return [np.asarray(o) for o in outs], state


def _tmixes(policy, xs):
    ctx = tp.ConsensusContext(xs[0].shape[0])
    state = policy.init_state(torch.from_numpy(xs[0]), ctx)
    outs = []
    for x in xs:
        y, state = policy.mix(torch.from_numpy(x), state, ctx)
        outs.append(y)
    return outs, state


def _problem(m, seed, n=16, q=3, j=160):
    """The reference tests' (n, j) problem split over m workers, from numpy."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, j)).astype(np.float32)
    t = rng.standard_normal((q, j)).astype(np.float32)
    yw = y.reshape(n, m, j // m).transpose(1, 0, 2).copy()
    tw = t.reshape(q, m, j // m).transpose(1, 0, 2).copy()
    return yw, tw


# ---------------------------------------------------------------------------
# FaultModel: validation and draws
# ---------------------------------------------------------------------------


FAULT_REFUSALS = [
    lambda p: p.FaultModel(drop=1.5),
    lambda p: p.FaultModel(drop=-0.1),
    lambda p: p.FaultModel(straggle=0, stragglers=(1,)),
    lambda p: p.FaultModel(fail_at=-1),
    lambda p: p.FaultModel(failed=(9,)).validate(4),
    lambda p: p.FaultModel(stragglers=(-1,)).validate(4),
    lambda p: p.FaultModel(failed=(0, 1, 2, 3)).validate(4),
    lambda p: p.FaultModel(byzantine=(0, 1, 2, 3)).validate(4),
    lambda p: p.AsyncGossip(interval=0),
    lambda p: p.AsyncGossip(rounds=0),
    lambda p: p.AsyncGossip(topology="ring"),
    lambda p: p.AsyncGossip(faults="drop"),
    lambda p: p.AsyncGossip(wire_dtype="int8"),
]


@pytest.mark.parametrize("build", FAULT_REFUSALS, ids=range(len(FAULT_REFUSALS)))
def test_fault_model_refuses_like_reference(build):
    with pytest.raises((ValueError, TypeError)) as e:
        build(tp)
    with pytest.raises(type(e.value)) as je:
        build(jp)
    assert str(e.value) == str(je.value)


def test_fault_model_fields_and_properties_match_reference():
    kws = [dict(), dict(drop=0.1), dict(failed=(3, 2)), dict(failed=(2,), fail_at=5),
           dict(stragglers=(2, 0), straggle=3), dict(byzantine=(1,), attack="replay:3"),
           dict(attack="nanbomb"), dict(byzantine=(4, 1), attack="scale:10")]
    for kw in kws:
        mine, ref = tp.FaultModel(**kw), jp.FaultModel(**kw)
        assert repr(mine) == repr(ref)
        assert (mine.is_null, mine.attack_kind, mine.attack_param, mine.replay_depth) == \
            (ref.is_null, ref.attack_kind, ref.attack_param, ref.replay_depth)
    assert hash(tp.FaultModel(drop=0.1)) == hash(tp.FaultModel(drop=0.1))


@pytest.mark.parametrize("kw,m", [
    (dict(drop=0.5, seed=3), 8), (dict(drop=0.1, seed=7), 20), (dict(drop=0.9, seed=0), 5),
    (dict(failed=(1, 3), fail_at=5), 6), (dict(drop=0.3, seed=1, failed=(0,), fail_at=2), 16),
    (dict(), 4),
])
def test_alive_mask_bit_equal_to_reference(kw, m):
    mine, ref = tp.FaultModel(**kw), jp.FaultModel(**kw)
    for iteration in (0, 1, 4, 5, 7, 99, 2**31 - 1):
        for rnd in (0, 1, 51):
            got = mine.alive_mask(iteration, rnd, m)
            want = np.asarray(ref.alive_mask(iteration, rnd, m, jnp.float32))
            assert got.dtype == torch.float32 and got.shape == (m,)
            assert np.array_equal(got.numpy(), want), (iteration, rnd)
            assert np.array_equal(mine.alive_mask(iteration, rnd, m, torch.float64).numpy(), want)


def test_alive_mask_permanent_failure():
    fm = tp.FaultModel(failed=(1, 3), fail_at=5)
    assert np.array_equal(fm.alive_mask(4, 0, 6).numpy(), np.ones(6))
    after = [1, 0, 1, 0, 1, 1]
    assert np.array_equal(fm.alive_mask(5, 0, 6).numpy(), after)
    assert np.array_equal(fm.alive_mask(100, 2, 6).numpy(), after)


# ---------------------------------------------------------------------------
# faulty_schedule_gossip_step
# ---------------------------------------------------------------------------


def _schedules(t):
    return {
        "uniform": t.Ring(2).exchange_schedule(6),
        "power": t.Ring(2).power_schedule(6, 3),
        "geometric": t.RandomGeometric(0.5, seed=1).exchange_schedule(6),
    }


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["uniform", "power", "geometric"])
@pytest.mark.parametrize("transmit", [False, True])
def test_faulty_schedule_gossip_step_matches_reference(kind, wire, transmit):
    x, s = _x(6, 1), _x(6, 2)
    alive = np.array([1, 0, 1, 1, 0, 1], np.float32)
    j_sched = _schedules(jt)[kind]

    def ref(xi, si, me):
        return jc.faulty_schedule_gossip_step(
            xi, "w", j_sched, jnp.asarray(alive), worker_index=me,
            transmit=si if transmit else None, wire_dtype=wire)

    want = jax.vmap(ref, axis_name="w")(jnp.asarray(x), jnp.asarray(s), jnp.arange(6))
    got = tc.faulty_schedule_gossip_step(
        torch.from_numpy(x), _schedules(tt)[kind], torch.from_numpy(alive),
        transmit=torch.from_numpy(s) if transmit else None, wire_dtype=wire)
    _close(got, want, np.maximum(np.abs(x), np.abs(s)))
    # A down worker holds its own value.
    if not transmit:
        assert np.allclose(got.numpy()[[1, 4]], x[[1, 4]], atol=1e-6)


def test_faulty_link_weights_reroute_every_dead_link():
    sched = tt.Ring(2).exchange_schedule(6)
    alive = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.float32)
    coef, lost = tc.faulty_link_weights(sched, alive)
    rows = sched.self_weight + coef.sum(0) + lost
    assert torch.allclose(rows, torch.ones(6), atol=1e-6)
    assert torch.equal(coef[:, [1, 4]], torch.zeros(4, 2))


def test_faulty_step_multiplies_nan_through_dead_links_like_reference():
    """The vulnerable baseline: a NaN payload from a DEAD worker still
    reaches its peers, since the gate multiplies (0 * NaN is NaN)."""
    x = _x(5, 3)
    tx = x.copy()
    tx[2] = np.nan
    alive = np.array([1, 1, 0, 1, 1], np.float32)
    sched = tt.Ring(1).exchange_schedule(5)
    got = tc.faulty_schedule_gossip_step(
        torch.from_numpy(x), sched, torch.from_numpy(alive), transmit=torch.from_numpy(tx))
    want = jax.vmap(lambda xi, ti, me: jc.faulty_schedule_gossip_step(
        xi, "w", jt.Ring(1).exchange_schedule(5), jnp.asarray(alive), worker_index=me,
        transmit=ti), axis_name="w")(jnp.asarray(x), jnp.asarray(tx), jnp.arange(5))
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    assert np.isnan(got.numpy()[[1, 3]]).all() and np.isfinite(got.numpy()[[0, 2, 4]]).all()
    _close(got, want, x)


@pytest.mark.parametrize("m", [3, 5, 8, 13, 16])
@pytest.mark.parametrize("seed", [0, 3])
def test_faulty_mix_mean_preserving(m, seed):
    """Under drops every killed weight goes to the diagonal symmetrically:
    the all-worker mean is invariant (inverse-closed ring schedule)."""
    pol = tp.AsyncGossip(rounds=2, topology=tt.Ring(1), faults=tp.FaultModel(drop=0.4, seed=seed))
    pol.validate(m)
    x = _x(m, seed, (5,))
    (y,), _ = _tmixes(pol, [x])
    np.testing.assert_allclose(y.numpy().mean(0), x.mean(0), atol=1e-5)


@pytest.mark.parametrize("gone", [(2,), (0, 5), (1, 2, 3), (6, 7)])
def test_masked_faulty_mix_mean_preserving_on_active_set(gone):
    m = 8
    mem = tt.Membership.all(m).without(*gone)
    pol = tp.AsyncGossip(rounds=2, topology=tt.Masked(tt.Ring(2), mem),
                         faults=tp.FaultModel(drop=0.3, seed=len(gone)))
    pol.validate(m)
    x = _x(m, 4, (4,))
    (y,), _ = _tmixes(pol, [x])
    active = np.asarray(mem.mask()).astype(bool)
    np.testing.assert_allclose(y.numpy()[active].mean(0), x[active].mean(0), atol=1e-5)
    np.testing.assert_allclose(y.numpy()[~active], x[~active], atol=1e-6)
    (want,), _ = _jmixes(jp.AsyncGossip(rounds=2, topology=jt.Masked(jt.Ring(2), jt.Membership.all(
        m).without(*gone)), faults=jp.FaultModel(drop=0.3, seed=len(gone))), [x])
    _close(y, want, x)


# ---------------------------------------------------------------------------
# AsyncGossip, mix by mix
# ---------------------------------------------------------------------------


#: AsyncGossip specs: the grammar's five entries, then every fault source
#: and the attacks through the vulnerable baseline.
ASYNC_SPECS = [
    ("async:rounds=2", 8), ("async:interval=2:rounds=2", 8), ("async:interval=4@ring:2", 8),
    ("async:drop=0.2:seed=3@hypercube", 16), ("async:rounds=2@ring:1+hypercube", 8),
    ("async:rounds=3:drop=0.3:seed=5@ring:2", 7), ("async:rounds=2:fail=1+4:fail_at=1", 6),
    ("async:stragglers=0+2:straggle=2", 5), ("async:rounds=2:stragglers=1:drop=0.2@ring:2", 8),
    ("async:rounds=2:byz=3:attack=signflip@ring:2", 8), ("async:byz=1:attack=scale:10", 6),
    ("async:rounds=2:attack=noise:0.5@ring:2", 8), ("async:rounds=2:byz=3:attack=nanbomb", 8),
    ("async:rounds=2:byz=2:attack=replay:2:drop=0.2", 6), ("async:rounds=2:wire=bf16:drop=0.1", 6),
    ("async:rounds=2:drop=0.2@ring:1+ring:2", 8),
    ("async:rounds=3:stragglers=1:byz=4:attack=replay:1:fail=2:fail_at=1@ring:2", 8),
]


@pytest.mark.parametrize("spec,m", ASYNC_SPECS, ids=[s for s, _ in ASYNC_SPECS])
def test_async_mixes_match_reference(spec, m):
    """Three mixes from one state: values within MIX_TOL (noise within the
    normal's ulps), the same non-finite entries, and the same state."""
    from repro import dssfn as jdssfn
    from repro_torch import dssfn

    pol, ref = dssfn.parse_spec(spec), jdssfn.parse_spec(spec)
    assert pol.describe() == ref.describe()
    xs = [_x(m, 10 + i) for i in range(3)]
    got, state = _tmixes(pol, xs)
    want, jstate = _jmixes(ref, xs)
    for g, w, x in zip(got, want, xs):
        _close(g, w, x)
    assert state[0] == 3 and np.all(np.asarray(jstate[0]) == 3)
    assert len(state) == len(jstate)
    for buf, jbuf in zip(state[1:], jstate[1:]):
        # repro's buffers are per worker under vmap: (M, depth, ...).
        assert np.array_equal(buf.numpy(), np.moveaxis(np.asarray(jbuf), 0, 1))


@pytest.mark.parametrize("rounds,topo", [(1, "ring"), (3, "ring:2"), (2, "hypercube"),
                                         (2, "ring:1+hypercube"), (4, "torus:2x4")])
def test_null_fault_async_bit_identical_to_serial_gossip(rounds, topo):
    x = _x(8, 3, (4, 6))
    graph = tt.parse_topology(topo)
    (a,), _ = _tmixes(tp.AsyncGossip(rounds=rounds, topology=graph), [x])
    (g,), _ = _tmixes(tp.Gossip(rounds=rounds, topology=graph, compress=False), [x])
    assert torch.equal(a, g)


def test_straggler_transmits_stale_value():
    """A straggler puts its `straggle`-calls-old value on the wire (zeros
    before any history) while its own contribution stays fresh."""
    m, straggler = 4, 1
    pol = tp.AsyncGossip(rounds=1, topology=tt.Ring(1),
                         faults=tp.FaultModel(stragglers=(straggler,), straggle=1))
    x1, x2 = _x(m, 1, (3,)), _x(m, 2, (3,))
    (y1, y2), state = _tmixes(pol, [x1, x2])
    h = tt.Ring(1).mixing_matrix(m)
    off = h - np.diag(np.diag(h))

    def expected(x, stale):
        tx = x.copy()
        tx[straggler] = stale[straggler]
        return np.diag(h)[:, None] * x + off @ tx

    np.testing.assert_allclose(y1.numpy(), expected(x1, np.zeros((m, 3))), atol=1e-6)
    np.testing.assert_allclose(y2.numpy(), expected(x2, x1), atol=1e-6)
    assert torch.equal(state[1][0], torch.from_numpy(x2))


def test_async_rotates_time_varying_schedules_across_calls():
    m = 8
    pol = tp.AsyncGossip(rounds=1, topology=tt.TimeVarying((tt.Ring(1), tt.Hypercube())))
    xs = [_x(m, 8, (3,)), _x(m, 9, (3,)), _x(m, 10, (3,))]
    ys, _ = _tmixes(pol, xs)
    for y, x, h in zip(ys, xs, (tt.Ring(1), tt.Hypercube(), tt.Ring(1))):
        np.testing.assert_allclose(y.numpy(), h.mixing_matrix(m) @ x, atol=1e-5)
    want, _ = _jmixes(jp.AsyncGossip(rounds=1, topology=jt.TimeVarying((jt.Ring(1), jt.Hypercube()))), xs)
    for y, w, x in zip(ys, want, xs):
        _close(y, w, x)


def test_fault_validation_requires_inverse_closure_like_reference():
    faults = (tp.FaultModel(drop=0.1), jp.FaultModel(drop=0.1))
    for spec in ("ring:2", "hypercube", "geometric:0.5:1"):
        mine = tp.AsyncGossip(rounds=1, topology=tt.parse_topology(spec), faults=faults[0])
        ref = jp.AsyncGossip(rounds=1, topology=jt.parse_topology(spec), faults=faults[1])
        closed = tt.is_inverse_closed(tt.cached_exchange_schedule(mine.topology, 8))
        if closed:
            mine.validate(8)
            ref.validate(8)
            continue
        with pytest.raises(ValueError, match="inverse-closed") as e:
            mine.validate(8)
        with pytest.raises(ValueError) as je:
            ref.validate(8)
        assert str(e.value) == str(je.value)


# ---------------------------------------------------------------------------
# the communication interval
# ---------------------------------------------------------------------------


def test_interval_comm_accounting_matches_reference():
    kw = dict(scalars=100, num_consensus=40, num_workers=8)
    for rounds, interval in ((2, 1), (2, 4), (3, 5), (52, 4)):
        mine = tp.AsyncGossip(rounds=rounds, topology=tt.Ring(2), interval=interval)
        ref = jp.AsyncGossip(rounds=rounds, topology=jt.Ring(2), interval=interval)
        assert mine.communication_interval == ref.communication_interval == interval
        assert mine.comm_scalars(**kw) == ref.comm_scalars(**kw)
        assert mine.wire_bytes(**kw) == ref.wire_bytes(**kw)
    assert tp.AsyncGossip(rounds=2, topology=tt.Ring(2), interval=4).comm_scalars(**kw) == \
        100 * 8 * 10
    assert tp.Gossip(rounds=2, topology=tt.Ring(2)).communication_interval == 1


#: ADMM solves under the fault model (M, spec): intervals, drops,
#: failures, stragglers and attackers through the vulnerable baseline.
ADMM_CASES = [
    (8, "async:interval=4:rounds=3@hypercube"),
    (8, "async:interval=2:rounds=2:drop=0.2:seed=1@ring:2"),
    (8, "async:rounds=3:drop=0.2:seed=11@hypercube"),
    (8, "async:rounds=2:fail=2+5:fail_at=10@ring:2"),
    (4, "async:interval=2:rounds=2:stragglers=1:drop=0.1"),
    (8, "async:rounds=3:byz=3:attack=signflip@hypercube"),
    (8, "async:interval=5:rounds=2:byz=2:attack=replay:1@ring:2"),
]


@pytest.mark.parametrize("m,spec", ADMM_CASES, ids=[s for _, s in ADMM_CASES])
def test_admm_under_faults_matches_reference(m, spec):
    """o_star within 1e-4 of repro's, and the traces of EVERY iteration,
    local ones of an interval included, within rtol 1e-4."""
    from repro import dssfn as jdssfn
    from repro_torch import dssfn

    yw, tw = _problem(m, seed=m)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=40)
    res = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                    backend=SimulatedBackend(m), policy=dssfn.parse_spec(spec), **kw)
    ref = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(m),
                                     policy=jdssfn.parse_spec(spec), **kw)
    assert _rel(res.o_star.numpy(), ref.o_star) <= GAP
    for field in ("objective", "primal_residual", "dual_residual"):
        got, want = getattr(res.trace, field).numpy(), np.asarray(getattr(ref.trace, field))
        assert got.shape == want.shape == (40,)
        np.testing.assert_allclose(got, want, rtol=GAP, atol=1e-6 * np.abs(want).max())


def test_interval_iterates_do_not_depend_on_tracing():
    yw, tw = _problem(8, seed=6)
    pol = tp.AsyncGossip(rounds=3, topology=tt.Hypercube(), interval=4,
                         faults=tp.FaultModel(drop=0.1, seed=2))
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=40, policy=pol)
    args = (torch.from_numpy(yw), torch.from_numpy(tw))
    traced = admm.admm_ridge_consensus(*args, backend=SimulatedBackend(8), **kw)
    hot = admm.admm_ridge_consensus(*args, backend=SimulatedBackend(8), trace_every=0, **kw)
    assert hot.trace is None and torch.equal(traced.o_star, hot.o_star)
    # Interval mixing still lands close to the exact consensus solution.
    exact = admm.admm_ridge_consensus(*args, backend=SimulatedBackend(8), mu=1e-2,
                                      eps_radius=6.0, num_iters=40)
    assert _rel(traced.o_star.numpy(), exact.o_star.numpy()) < 0.35


def test_interval_local_rounds_leave_the_policy_state_alone():
    """K/N mixes a solve: with interval 4 and K=12, three calls."""
    calls = []

    class Counting(tp.AsyncGossip):
        def mix(self, x, state, ctx):
            calls.append(state[0])
            return super().mix(x, state, ctx)

    yw, tw = _problem(4, seed=2)
    admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw), mu=1e-2,
                              eps_radius=6.0, num_iters=12,
                              policy=Counting(rounds=1, topology=tt.Ring(1), interval=4))
    assert calls == [0, 1, 2]


@pytest.mark.parametrize("num_iters,trace_every", [(10, 1), (12, 2)])
def test_interval_validation_errors_match_reference(num_iters, trace_every):
    yw, tw = _problem(8, seed=7)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=num_iters, trace_every=trace_every)
    with pytest.raises(ValueError) as e:
        engine.fused_layer_step(SimulatedBackend(8), torch.from_numpy(yw), torch.from_numpy(tw),
                                None, policy=tp.AsyncGossip(topology=tt.Ring(1), interval=3), **kw)
    with pytest.raises(ValueError) as je:
        jengine.fused_layer_step(JBackend(8), jnp.asarray(yw), jnp.asarray(tw), None,
                                 policy=jp.AsyncGossip(topology=jt.Ring(1), interval=3), **kw)
    assert str(e.value) == str(je.value)
    with pytest.raises(ValueError) as e:
        admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                  policy=tp.AsyncGossip(topology=tt.Ring(1), interval=3), **kw)
    with pytest.raises(ValueError) as je:
        jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(8),
                                   policy=jp.AsyncGossip(topology=jt.Ring(1), interval=3), **kw)
    assert str(e.value) == str(je.value)


def test_faulty_training_deterministic_and_near_exact():
    yw, tw = _problem(8, seed=5)
    pol = tp.AsyncGossip(rounds=3, topology=tt.Hypercube(), faults=tp.FaultModel(drop=0.2, seed=11))
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=40, policy=pol)
    args = (torch.from_numpy(yw), torch.from_numpy(tw))
    a = admm.admm_ridge_consensus(*args, backend=SimulatedBackend(8), **kw)
    b = admm.admm_ridge_consensus(*args, backend=SimulatedBackend(8), **kw)
    assert torch.equal(a.o_star, b.o_star)
    exact = admm.admm_ridge_consensus(*args, mu=1e-2, eps_radius=6.0, num_iters=40)
    assert _rel(a.o_star.numpy(), exact.o_star.numpy()) < 0.25


def test_fault_models_ride_the_program_record():
    """Same policy shape, other fault model: a new program; repeated
    solves under one fault model: records hits, as repro's cache does."""
    yw, tw = _problem(8, seed=11)
    backend = SimulatedBackend(8)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=10, backend=backend)
    args = (torch.from_numpy(yw), torch.from_numpy(tw))
    pol = tp.AsyncGossip(rounds=2, topology=tt.Ring(1), faults=tp.FaultModel(drop=0.2, seed=7))
    for _ in range(3):
        admm.admm_ridge_consensus(*args, policy=pol, **kw)
    assert backend.lowerings == 1
    admm.admm_ridge_consensus(*args, policy=tp.AsyncGossip(
        rounds=2, topology=tt.Ring(1), faults=tp.FaultModel(drop=0.2, seed=8)), **kw)
    assert backend.lowerings == 2 and backend.cache_hits == 2


# ---------------------------------------------------------------------------
# the spec grammar
# ---------------------------------------------------------------------------


def test_parse_async_specs():
    assert tp.parse_policy("async") == tp.AsyncGossip()
    assert tp.parse_policy("async:interval=4:drop=0.1:seed=7") == tp.AsyncGossip(
        interval=4, faults=tp.FaultModel(drop=0.1, seed=7))
    assert tp.parse_policy("async:rounds=2:fail=1+3:fail_at=30") == tp.AsyncGossip(
        rounds=2, faults=tp.FaultModel(failed=(1, 3), fail_at=30))
    assert tp.parse_policy("async:stragglers=0+2:straggle=3") == tp.AsyncGossip(
        faults=tp.FaultModel(stragglers=(0, 2), straggle=3))
    assert tp.parse_policy("async:wire=bf16").wire_dtype == "bfloat16"
    assert tp.parse_policy("async:attack=nanbomb").faults.byzantine == (0,)


@pytest.mark.parametrize("spec", ["async:latency=3", "async:drop=0.1:drop=0.2", "async:4",
                                  "async:attack=meteor", "async:drop=2", "async:byz=1+x",
                                  "async:straggle=0:stragglers=1"])
def test_async_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as e:
        tp.parse_policy(spec)
    with pytest.raises(ValueError) as je:
        jp.parse_policy(spec)
    assert str(e.value) == str(je.value)
