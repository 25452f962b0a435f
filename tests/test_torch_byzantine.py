"""The port's Byzantine-robust consensus against repro's: the attacks,
the screened steps (``_receive_screened`` and the trimmed, median and
clipped rounds), the robust policies mix by mix and under ADMM, the
spec grammar, and the deprecated ``core/robust.py`` shim.

Bars:

- Mixes: within MIX_TOL = 1e-6 x max|x| of repro's on the same f32
  input, with the same non-finite entries, over three consecutive mixes
  that carry the state (the call count and the replay buffer).  The
  screens are discrete (a trim flag, a health gate, a clip), so a flipped
  decision would move a mix by a whole payload, 10**5 times the bar.
- The ``noise`` attack: its draw within the normal's 4 ulps of jax's
  (``prng.normal``, ROADMAP Queue 3).
- ADMM: the readout within a relative 1e-4 of repro's.
- Zero-attacker robust policies: bit-identical to the port's
  ``Gossip(compress=False)``.
- Validation errors: the reference's messages, word for word.

repro's own end-to-end bound (``test_byzantine.py::test_trimmed_mean_admm
_within_2x_of_no_attack_oracle_rel``) fails in repro itself; the port is
held to repro's outputs instead, never to that bound.
"""
import importlib
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dssfn as jdssfn
from repro.core import admm as jadmm
from repro.core import consensus as jc
from repro.core import policy as jp
from repro.core import topology as jt
from repro.core.backend import SimulatedBackend as JBackend
from repro_torch import dssfn
from repro_torch.core import admm
from repro_torch.core import consensus as tc
from repro_torch.core import policy as tp
from repro_torch.core import topology as tt
from repro_torch.core.backend import SimulatedBackend

MIX_TOL = 1e-6
GAP = 1e-4
NORMAL_ULPS = 4


def _x(m, seed, shape=(3, 5)):
    return np.random.default_rng(seed).standard_normal((m, *shape)).astype(np.float32)


def _close(got, want, x, tol=MIX_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64)).max(initial=0.0)
    assert err <= tol * np.nanmax(np.abs(x)), err


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jmixes(policy, xs):
    ctx = jp.ConsensusContext("w", xs[0].shape[0])

    def body(*xis):
        state = policy.init_state(xis[0], ctx)
        outs = []
        for xi in xis:
            y, state = policy.mix(xi, state, ctx)
            outs.append(y)
        return tuple(outs)

    return [np.asarray(o) for o in jax.vmap(body, axis_name="w")(*map(jnp.asarray, xs))]


def _tmixes(policy, xs):
    ctx = tp.ConsensusContext(xs[0].shape[0])
    state = policy.init_state(torch.from_numpy(xs[0]), ctx)
    outs = []
    for x in xs:
        y, state = policy.mix(torch.from_numpy(x), state, ctx)
        outs.append(y)
    return outs


def _problem(m, seed, n=16, q=3, j=160):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, j)).astype(np.float32)
    t = rng.standard_normal((q, j)).astype(np.float32)
    yw = y.reshape(n, m, j // m).transpose(1, 0, 2).copy()
    tw = t.reshape(q, m, j // m).transpose(1, 0, 2).copy()
    return yw, tw


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attack", ["meteor", "signflip:2", "nanbomb:1", "scale", "noise",
                                    "replay", "replay:0", "replay:x", "scale:y"])
def test_attack_spec_refuses_like_reference(attack):
    with pytest.raises(ValueError) as e:
        tp.FaultModel(attack=attack)
    with pytest.raises(ValueError) as je:
        jp.FaultModel(attack=attack)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("attack", ["signflip", "scale:10", "scale:-0.3", "nanbomb", "replay:1"])
def test_corrupted_payload_matches_reference(attack):
    fm, ref = tp.FaultModel(byzantine=(0,), attack=attack), jp.FaultModel(byzantine=(0,), attack=attack)
    x = _x(4, 1)
    buf = _x(4, 2)
    got = fm.corrupted_payload(torch.from_numpy(x), iteration=3, round_idx=1,
                               replay=torch.from_numpy(buf))
    for i in range(4):
        want = np.asarray(ref.corrupted_payload(jnp.asarray(x[i]), iteration=3, round_idx=1,
                                                replay=jnp.asarray(buf[i])))
        assert np.array_equal(got.numpy()[i], want, equal_nan=True)
    if attack.startswith("replay"):
        with pytest.raises(ValueError, match="replay attack needs"):
            fm.corrupted_payload(torch.from_numpy(x), iteration=0, round_idx=0)


@pytest.mark.parametrize("iteration,rnd", [(0, 0), (3, 1), (3, 2), (97, 51)])
def test_noise_attack_within_normal_ulps_of_reference(iteration, rnd):
    """Every worker draws the same N(0,1) from one (seed, iteration,
    round) key; the draw is within NORMAL_ULPS of jax's."""
    fm = tp.FaultModel(byzantine=(0,), attack="noise:0.5", seed=4)
    ref = jp.FaultModel(byzantine=(0,), attack="noise:0.5", seed=4)
    x = np.zeros((3, 10, 41), np.float32)
    got = fm.corrupted_payload(torch.from_numpy(x), iteration=iteration, round_idx=rnd).numpy()
    want = np.asarray(ref.corrupted_payload(jnp.asarray(x[0]), iteration=iteration, round_idx=rnd))
    assert np.array_equal(got[0], got[2])
    ulps = np.abs(got[0].view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS
    again = fm.corrupted_payload(torch.from_numpy(x), iteration=iteration, round_idx=rnd + 1)
    assert not np.array_equal(again.numpy(), got)


def test_transmit_for_corrupts_only_byzantine_slots():
    fm = tp.FaultModel(byzantine=(1, 3), attack="signflip")
    x = torch.ones((5, 4))
    tx = fm.transmit_for(x, iteration=0, round_idx=0)
    assert torch.equal(tx, torch.tensor([1.0, -1, 1, -1, 1])[:, None].expand(5, 4))
    nan = tp.FaultModel(byzantine=(2,), attack="nanbomb").transmit_for(x, iteration=0, round_idx=0)
    assert torch.isnan(nan[2]).all() and torch.isfinite(nan[[0, 1, 3, 4]]).all()
    assert tp.FaultModel().transmit_for(x, iteration=0, round_idx=0) is x


# ---------------------------------------------------------------------------
# screened steps
# ---------------------------------------------------------------------------


def _ref_step(step, sched, x, alive, tx, **kw):
    def body(xi, ti, me):
        return step(xi, "w", sched, alive=None if alive is None else jnp.asarray(alive),
                    worker_index=me, transmit=None if tx is None else ti, **kw)

    t = x if tx is None else tx
    return np.asarray(jax.vmap(body, axis_name="w")(jnp.asarray(x), jnp.asarray(t),
                                                   jnp.arange(x.shape[0])))


STEPS = {
    "trimmed": (tc.trimmed_mean_schedule_gossip_step, jc.trimmed_mean_schedule_gossip_step,
                dict(trim=1)),
    "trimmed0": (tc.trimmed_mean_schedule_gossip_step, jc.trimmed_mean_schedule_gossip_step,
                 dict(trim=0)),
    "median": (tc.median_schedule_gossip_step, jc.median_schedule_gossip_step, {}),
    "clipped": (tc.clipped_schedule_gossip_step, jc.clipped_schedule_gossip_step, dict(tau=0.7)),
}


def _attacked(x, kind):
    tx, m = x.copy(), x.shape[0]
    if kind == "signflip":
        tx[[1, m - 3]] = -8.0 * x[[1, m - 3]]
    elif kind == "nanbomb":
        tx[2] = np.nan
        tx[m - 2, 0, 0] = np.inf
    return tx


@pytest.mark.parametrize("step", list(STEPS))
@pytest.mark.parametrize("topo,m", [("ring:2", 8), ("hypercube", 8), ("ring:1", 5), ("ring:3", 9)])
@pytest.mark.parametrize("attack", ["none", "signflip", "nanbomb"])
@pytest.mark.parametrize("drop", [False, True])
def test_screened_steps_match_reference(step, topo, m, attack, drop):
    mine, ref, kw = STEPS[step]
    x = _x(m, 7)
    tx = None if attack == "none" else _attacked(x, attack)
    alive = None
    if drop:
        alive = np.ones(m, np.float32)
        alive[[0, 3]] = 0.0
    got = mine(torch.from_numpy(x), tt.parse_topology(topo).exchange_schedule(m),
               alive=None if alive is None else torch.from_numpy(alive),
               transmit=None if tx is None else torch.from_numpy(tx), **kw)
    want = _ref_step(ref, jt.parse_topology(topo).exchange_schedule(m), x, alive, tx, **kw)
    _close(got, want, x)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("kind", ["power", "geometric"])
def test_clipped_step_on_weighted_schedules_matches_reference(kind):
    scheds = {"power": lambda t: t.Ring(2).power_schedule(8, 3),
              "geometric": lambda t: t.RandomGeometric(0.5, seed=1).exchange_schedule(8)}
    x = _x(8, 3)
    tx = _attacked(x, "signflip")
    got = tc.clipped_schedule_gossip_step(torch.from_numpy(x), scheds[kind](tt), tau=0.5,
                                          transmit=torch.from_numpy(tx))
    want = _ref_step(jc.clipped_schedule_gossip_step, scheds[kind](jt), x, None, tx, tau=0.5)
    _close(got, want, x)


def test_clipped_pass_through_equals_weighted_gossip_step():
    """Every payload inside the ball passes untouched: the step is the
    weighted ``schedule_gossip_step``, bit for bit."""
    sched = tt.Ring(2).power_schedule(8, 3)
    x = torch.from_numpy(_x(8, 4))
    assert torch.equal(tc.clipped_schedule_gossip_step(x, sched, tau=1e6),
                       tc.schedule_gossip_step(x, sched))


def test_even_stack_median_is_the_midpoint_like_reference():
    """A hypercube on 8 workers gives each receiver a stack of 4: the
    median is (lo + hi) / 2 of the middle pair, as jnp.median takes it;
    torch.median (the lower one) and torch.quantile differ."""
    x = _x(8, 12, (6, 7))
    sched = tt.Hypercube().exchange_schedule(8)
    assert len(sched.perms) + 1 == 4
    got = tc.median_schedule_gossip_step(torch.from_numpy(x), sched)
    want = _ref_step(jc.median_schedule_gossip_step, jt.Hypercube().exchange_schedule(8), x,
                     None, None)
    assert np.array_equal(got.numpy(), want)
    stack = torch.cat([torch.from_numpy(x)[None], tc._gather_steps(torch.from_numpy(x), sched,
                                                                    torch.float32)])
    assert not torch.equal(torch.median(stack, dim=0).values, got)
    quant = torch.quantile(stack, 0.5, dim=0)
    assert not torch.equal(quant, got)
    np.testing.assert_allclose(quant.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_nanmedian_matches_jnp_nanmedian(seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((8, 30)).astype(np.float32)
    v[rng.random((8, 30)) < 0.4] = np.nan
    v[:, 0] = np.nan                       # a column with no finite value
    v[:7, 1] = np.nan                      # one finite value
    v[7, 1] = 0.25
    v[2:6, 2] = np.inf
    got = tc._nanmedian0(torch.from_numpy(v)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(v), axis=0))
    assert np.array_equal(got, want, equal_nan=True)
    assert np.isnan(got[0]) and got[1] == v[7, 1]


def test_trim_rank_ties_break_by_step_order_like_reference():
    """Receiver 0 of a degree-2 ring on 5 workers gets +V and -V (equal
    distances, both beyond the screen) and two small payloads; trim=1
    flags only the first of the tied links in step order, and which one
    it is changes the mix."""
    m, v = 5, np.full((3, 5), 40.0, np.float32)
    x = np.zeros((m, 3, 5), np.float32)
    x[1:] = 0.01 * _x(4, 2)
    sched = tt.Ring(2).exchange_schedule(m)
    src = [dict((d, s) for s, d in p)[0] for p in sched.perms]
    x[src[0]], x[src[1]] = v, -v
    got = tc.trimmed_mean_schedule_gossip_step(torch.from_numpy(x), sched, trim=1)
    want = _ref_step(jc.trimmed_mean_schedule_gossip_step, jt.Ring(2).exchange_schedule(m), x,
                     None, None, trim=1)
    assert np.array_equal(got.numpy()[0], want[0])
    kept_second = (x[0] + x[0] + x[src[1]] + x[src[2]] + x[src[3]]) / 5
    np.testing.assert_allclose(got.numpy()[0], kept_second, rtol=1e-6, atol=1e-7)
    # Two rerouted (NaN) links tie at +inf, rank first and use up the trim.
    tx = x.copy()
    tx[src[2]] = np.nan
    tx[src[3]] = np.nan
    got = tc.trimmed_mean_schedule_gossip_step(torch.from_numpy(x), sched, trim=1,
                                               transmit=torch.from_numpy(tx))
    want = _ref_step(jc.trimmed_mean_schedule_gossip_step, jt.Ring(2).exchange_schedule(m), x,
                     None, tx, trim=1)
    _close(got, want, x)


def test_nan_screen_reroutes_link_weight_to_diagonal():
    m = 8
    x = _x(m, 0, (3,))
    fm = tp.FaultModel(byzantine=(0,), attack="nanbomb")
    (out,) = _tmixes(tp.TrimmedMeanGossip(f=1, rounds=1, topology=tt.Ring(1), faults=fm), [x])
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy()[1], (x[1] + x[1] + x[2]) / 3.0, rtol=1e-6)
    np.testing.assert_allclose(out.numpy()[4], (x[3] + x[4] + x[5]) / 3.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the robust policies, mix by mix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("kind", ["trimmed", "median", "clipped"])
def test_robust_policies_bit_identical_to_gossip_when_clean(m, kind):
    x = _x(m, m, (5,))
    make = {
        "trimmed": lambda t: tp.TrimmedMeanGossip(f=1, rounds=3, topology=t),
        "median": lambda t: tp.MedianGossip(rounds=3, topology=t),
        "clipped": lambda t: tp.ClippedGossip(tau=0.5, rounds=3, topology=t),
    }[kind]
    for topo in (tt.Ring(1), tt.TimeVarying((tt.Ring(1), tt.Ring(1)))):
        (out,) = _tmixes(make(topo), [x])
        (ref,) = _tmixes(tp.Gossip(rounds=3, topology=topo, compress=False), [x])
        assert torch.equal(out, ref), (kind, topo)


#: Robust specs: the grammar's five entries, then every attack, drops and
#: failures through each estimator.
ROBUST_SPECS = [
    ("trimmed:f=1:attack=signflip", 8), ("trimmed:f=1:attack=scale:10@hypercube", 16),
    ("median:attack=noise:0.5@ring:2", 8), ("clipped:0.5:attack=nanbomb", 8),
    ("clipped:tau=2.0:byz=0+3:attack=replay:2@torus:2x4", 8),
    ("trimmed:f=1:rounds=3:byz=3:attack=signflip@ring:2", 8),
    ("trimmed:f=2:rounds=2:byz=1+4:attack=nanbomb:drop=0.2@ring:3", 9),
    ("trimmed:f=1:rounds=2:drop=0.3:seed=4:fail=2:fail_at=1@ring:2", 8),
    ("trimmed:f=1:rounds=2:byz=2:attack=replay:1@ring:1+ring:2", 8),
    ("median:rounds=3:byz=3+5:attack=nanbomb@ring:2", 8),
    ("median:rounds=2:byz=1:attack=scale:-3:drop=0.2@hypercube", 8),
    ("clipped:0.3:rounds=2:byz=2:attack=signflip:drop=0.3@ring:2", 8),
    ("clipped:tau=1.0:rounds=2:byz=1:attack=noise:2@geometric:0.6:1", 8),
    ("trimmed:f=1:rounds=2:byz=0:attack=signflip:wire=bf16@ring:2", 8),
]


@pytest.mark.parametrize("spec,m", ROBUST_SPECS, ids=[s for s, _ in ROBUST_SPECS])
def test_robust_mixes_match_reference(spec, m):
    pol, ref = dssfn.parse_spec(spec), jdssfn.parse_spec(spec)
    assert pol.describe() == ref.describe()
    pol.validate(m)
    xs = [_x(m, 20 + i) for i in range(3)]
    tol = MIX_TOL if "noise" not in spec else 1e-5     # the normal's ulps, times the scale
    for got, want, x in zip(_tmixes(pol, xs), _jmixes(ref, xs), xs):
        _close(got, want, x, tol)
        assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("attack", ["signflip", "nanbomb"])
def test_robust_mix_tolerates_one_attacker(m, attack):
    """Concentrated honest values, one attacker: the robust mixes stay in
    the honest hull; the vulnerable AsyncGossip is thrown out of it (or
    NaN-poisoned), in the port as in repro."""
    spread = 0.01
    honest = (2.0 + spread * np.random.default_rng(m).standard_normal((m, 4))).astype(np.float32)
    fm = tp.FaultModel(byzantine=(3,), attack=attack)
    hmean = np.delete(honest, 3, axis=0).mean(axis=0)
    for pol in (tp.TrimmedMeanGossip(f=1, rounds=2, topology=tt.Hypercube(), faults=fm),
                tp.MedianGossip(rounds=2, topology=tt.Hypercube(), faults=fm),
                tp.ClippedGossip(tau=5 * spread, rounds=2, topology=tt.Hypercube(), faults=fm)):
        (out,) = _tmixes(pol, [honest])
        assert bool(torch.isfinite(out).all())
        assert float(np.abs(out.numpy() - hmean).max()) < 10 * spread
    (vuln,) = _tmixes(tp.AsyncGossip(rounds=2, topology=tt.Hypercube(), faults=fm), [honest])
    if attack == "nanbomb":
        assert not bool(torch.isfinite(vuln).all())
    else:
        assert float(np.abs(vuln.numpy() - hmean).max()) > 10 * spread


# ---------------------------------------------------------------------------
# ADMM under attack
# ---------------------------------------------------------------------------


ADMM_SPECS = [
    "trimmed:f=1:rounds=3:byz=3:attack=signflip@hypercube",
    "trimmed:f=1:rounds=3:byz=3:attack=nanbomb@hypercube",
    "median:rounds=3:byz=3:attack=nanbomb@ring:2",
    "clipped:0.5:rounds=2:byz=1:attack=noise:0.5@ring:2",
    "async:rounds=3:byz=3:attack=signflip@hypercube",
    "trimmed:f=1:rounds=3@hypercube",
]


@pytest.mark.parametrize("spec", ADMM_SPECS)
def test_admm_under_attack_matches_reference(spec):
    m = 8
    yw, tw = _problem(m, seed=4)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=40)
    res = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                    backend=SimulatedBackend(m), policy=dssfn.parse_spec(spec), **kw)
    ref = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(m),
                                     policy=jdssfn.parse_spec(spec), **kw)
    assert _rel(res.o_star.numpy(), ref.o_star) <= GAP
    np.testing.assert_allclose(res.trace.objective.numpy(), np.asarray(ref.trace.objective),
                               rtol=GAP)


def test_vulnerable_baseline_is_poisoned_like_reference():
    m = 8
    yw, tw = _problem(m, seed=4)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=10)
    spec = "async:rounds=3:byz=3:attack=nanbomb@hypercube"
    res = admm.admm_ridge_consensus(torch.from_numpy(yw), torch.from_numpy(tw),
                                    backend=SimulatedBackend(m), policy=dssfn.parse_spec(spec), **kw)
    ref = jadmm.admm_ridge_consensus(jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(m),
                                     policy=jdssfn.parse_spec(spec), **kw)
    assert not bool(torch.isfinite(res.o_star).all())
    assert np.array_equal(np.isfinite(res.o_star.numpy()), np.isfinite(np.asarray(ref.o_star)))


def test_byzantine_fault_models_ride_the_program_record():
    m = 8
    yw, tw = _problem(m, seed=11)
    backend = SimulatedBackend(m)
    kw = dict(mu=1e-2, eps_radius=6.0, num_iters=5, backend=backend)
    args = (torch.from_numpy(yw), torch.from_numpy(tw))
    pols = [
        tp.TrimmedMeanGossip(f=1, rounds=2, topology=tt.Hypercube()),
        tp.TrimmedMeanGossip(f=1, rounds=2, topology=tt.Hypercube(),
                             faults=tp.FaultModel(byzantine=(3,), attack="signflip")),
        tp.MedianGossip(rounds=2, topology=tt.Hypercube(),
                        faults=tp.FaultModel(byzantine=(3,), attack="scale:10")),
        tp.ClippedGossip(tau=0.5, rounds=2, topology=tt.Hypercube(),
                         faults=tp.FaultModel(byzantine=(3,), attack="noise:0.5")),
    ]
    for _ in range(2):
        for pol in pols:
            admm.admm_ridge_consensus(*args, policy=pol, **kw)
    assert backend.lowerings == len(pols) and backend.cache_hits == len(pols)


# ---------------------------------------------------------------------------
# the spec grammar and validation
# ---------------------------------------------------------------------------


def test_parse_robust_specs_round_trip():
    cases = {
        "trimmed": tp.TrimmedMeanGossip(),
        "trimmed:f=2:rounds=3": tp.TrimmedMeanGossip(f=2, rounds=3),
        "trimmed:f=1:attack=signflip@torus:2x4": tp.TrimmedMeanGossip(
            f=1, topology=tt.Torus(2, 4), faults=tp.FaultModel(byzantine=(0,), attack="signflip")),
        "median:byz=3:attack=nanbomb@hypercube": tp.MedianGossip(
            topology=tt.Hypercube(), faults=tp.FaultModel(byzantine=(3,), attack="nanbomb")),
        "clipped:0.5": tp.ClippedGossip(tau=0.5),
        "clipped:tau=0.5:byz=1+2:attack=replay:3": tp.ClippedGossip(
            tau=0.5, faults=tp.FaultModel(byzantine=(1, 2), attack="replay:3")),
        "trimmed:attack=scale:10:rounds=2": tp.TrimmedMeanGossip(
            rounds=2, faults=tp.FaultModel(byzantine=(0,), attack="scale:10")),
        "trimmed:wire=bf16": tp.TrimmedMeanGossip(wire_dtype="bfloat16"),
    }
    for spec, expected in cases.items():
        assert dssfn.parse_spec(spec) == expected, spec
        assert expected.describe() == jdssfn.parse_spec(spec).describe()


@pytest.mark.parametrize("spec", ["clipped:0.5:tau=0.7", "trimmed:attack=meteor", "trimmed:f=0",
                                  "clipped:0", "median:rounds=0", "trimmed:f=1:colour=red",
                                  "clipped:tau=-1", "median:1"])
def test_robust_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as e:
        tp.parse_policy(spec)
    with pytest.raises(ValueError) as je:
        jp.parse_policy(spec)
    assert str(e.value) == str(je.value)


VALIDATION = [
    lambda p, t: p.TrimmedMeanGossip(f=1, topology=t.RandomGeometric(radius=0.9, seed=0)).validate(8),
    lambda p, t: p.TrimmedMeanGossip(f=2, topology=t.Ring(1)).validate(8),
    lambda p, t: p.MedianGossip(topology=t.Ring(1), faults=p.FaultModel(stragglers=(1,))).validate(8),
    lambda p, t: p.MedianGossip(topology=t.RandomGeometric(radius=0.9, seed=0)).validate(8),
    lambda p, t: p.ClippedGossip(tau=0.0),
    lambda p, t: p.ClippedGossip(topology=t.Ring(1), faults=p.FaultModel(byzantine=(9,))).validate(8),
    lambda p, t: p.MedianGossip(faults="none"),
    lambda p, t: p.TrimmedMeanGossip(topology="ring"),
]


@pytest.mark.parametrize("build", VALIDATION, ids=range(len(VALIDATION)))
def test_robust_policy_validation_errors_match_reference(build):
    with pytest.raises((ValueError, TypeError)) as e:
        build(tp, tt)
    with pytest.raises(type(e.value)) as je:
        build(jp, jt)
    assert str(e.value) == str(je.value)


def test_robust_policies_account_eq15_wire_like_reference():
    kw = dict(scalars=100, num_consensus=10, num_workers=8)
    for build in (lambda p, t, **k: p.TrimmedMeanGossip(f=1, rounds=2, topology=t.Hypercube(), **k),
                  lambda p, t, **k: p.MedianGossip(rounds=3, topology=t.Ring(2), **k),
                  lambda p, t, **k: p.ClippedGossip(tau=0.5, topology=t.Torus(2, 4), **k)):
        for wire in ("float32", "bfloat16"):
            mine, ref = build(tp, tt, wire_dtype=wire), build(jp, jt, wire_dtype=wire)
            assert mine.exchanges_for(8) == ref.exchanges_for(8)
            assert mine.comm_scalars(**kw) == ref.comm_scalars(**kw)
            assert mine.wire_bytes(**kw) == ref.wire_bytes(**kw)


def test_robust_module_is_deprecated_shim():
    sys.modules.pop("repro_torch.core.robust", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        robust = importlib.import_module("repro_torch.core.robust")
    assert any(issubclass(w.category, DeprecationWarning)
               and "repro_torch.core.policy" in str(w.message) for w in caught)
    assert robust.QuantizedGossip is tp.QuantizedGossip
    assert robust.LossyGossip is tp.LossyGossip
    assert robust.StaleMixing is tp.StaleMixing
    assert robust.quantize_stochastic is tc.quantize_stochastic
    assert robust.quantize_nearest is tc.quantize_nearest
