"""repro_torch.core.topology against repro.core.topology.

The port is a copy in float64 numpy, so the bar is the reference's own
arithmetic: identical permutations in identical order (schedules and
Birkhoff decompositions alike), weights, mixing matrices and spectral
gaps within 1e-12, counts (rounds for a tolerance, edges per node,
schedule depths) equal, and every refusal raising the same exception
type with the same message.  Each topology class is held at
M in {1, 2, 5, 8, 20}, where each either spans M workers or refuses to.
A schedule compiled by the Birkhoff path reconstructs its H within
1e-7, the residual mass ``birkhoff_decomposition`` itself allows.
"""
import numpy as np
import pytest

from repro.core import topology as J
from repro_torch.core import topology as T

WORKERS = [1, 2, 5, 8, 20]
TOL = 1e-12
BIRKHOFF_RESIDUAL = 1e-7


def _mask(m):
    """Every slot active except slot 1 (where there is one)."""
    return tuple(i != 1 for i in range(m))


#: One factory per topology class (and per variant worth telling apart),
#: taking the topology module and M.
FACTORIES = {
    "ring1": lambda t, m: t.Ring(1),
    "ring2": lambda t, m: t.Ring(2),
    "torus": lambda t, m: t.Torus(2, max(2, m // 2)),
    "hypercube": lambda t, m: t.Hypercube(),
    "full": lambda t, m: t.FullyConnected(),
    "geometric": lambda t, m: t.RandomGeometric(0.5, seed=3),
    "timevarying": lambda t, m: t.TimeVarying((t.Ring(1), t.FullyConnected())),
    "masked": lambda t, m: t.Masked(t.Ring(1), t.Membership(_mask(m))),
}


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return ("raise", type(e).__name__, str(e))


def _same(got, want, what):
    if want[0] == "raise":
        assert got == want, what
        return None, None
    assert got[0] == "ok", (what, got)
    return got[1], want[1]


def _same_schedule(a, b, what):
    assert a.num_workers == b.num_workers, what
    assert a.perms == b.perms, what
    np.testing.assert_allclose(a.weights, b.weights, rtol=0, atol=TOL, err_msg=what)
    assert abs(a.self_weight - b.self_weight) <= TOL, what
    assert a.uniform == b.uniform, what


@pytest.mark.parametrize("m", WORKERS)
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_topology_matches_reference(name, m):
    mine, ref = FACTORIES[name](T, m), FACTORIES[name](J, m)
    assert repr(mine) == repr(ref) and mine.describe() == ref.describe()
    assert mine == FACTORIES[name](T, m) and hash(mine) == hash(FACTORIES[name](T, m))

    h, h_ref = _same(_outcome(lambda: mine.mixing_matrix(m)),
                     _outcome(lambda: ref.mixing_matrix(m)), "mixing_matrix")
    if h is not None:
        np.testing.assert_allclose(h, h_ref, rtol=0, atol=TOL)
        assert T.check_doubly_stochastic(h).shape == (m, m)
    for what, fn in [
        ("exchange_schedule", lambda t: t.exchange_schedule(m)),
        ("power_schedule", lambda t: t.power_schedule(m, 3)),
    ]:
        s, s_ref = _same(_outcome(lambda: fn(mine)), _outcome(lambda: fn(ref)), what)
        if s is not None:
            _same_schedule(s, s_ref, what)
            assert T.is_inverse_closed(s) == J.is_inverse_closed(s_ref)
            # The schedule implements H (one round) or H^3.
            want = h if what == "exchange_schedule" else np.linalg.matrix_power(h, 3)
            if name == "timevarying" and what == "power_schedule":
                p = [t.mixing_matrix(m) for t in ref.cycle()]
                want = p[0] @ p[1] @ p[0]
            np.testing.assert_allclose(s.as_matrix(), want, rtol=0, atol=BIRKHOFF_RESIDUAL)
            sym, sym_ref = T.symmetrized_schedule(s), J.symmetrized_schedule(s_ref)
            _same_schedule(sym, sym_ref, "symmetrized")
            assert T.is_inverse_closed(sym)
            if np.allclose(want, want.T, atol=TOL):
                np.testing.assert_allclose(sym.as_matrix(), want, rtol=0,
                                           atol=BIRKHOFF_RESIDUAL)
    c, c_ref = _same(_outcome(lambda: T.compressed_schedule(mine, m, 4)),
                     _outcome(lambda: J.compressed_schedule(ref, m, 4)), "compressed")
    if c is not None:
        _same_schedule(c, c_ref, "compressed")
        assert T.compressed_schedule(mine, m, 4) is c          # memoized
    for what, fn in [
        ("spectral_gap", lambda t: t.spectral_gap(m)),
        ("rounds_for_tolerance", lambda t: t.rounds_for_tolerance(m, 1e-6)),
        ("edges_per_node", lambda t: t.edges_per_node(m)),
        ("edges_per_node(None)", lambda t: t.edges_per_node(None)),
    ]:
        got, want = _same(_outcome(lambda: fn(mine)), _outcome(lambda: fn(ref)), what)
        if got is not None:
            assert type(got) is type(want), what
            assert abs(got - want) <= TOL, (what, got, want)


@pytest.mark.parametrize("m", [2, 5, 8, 20])
@pytest.mark.parametrize("which", ["ring2_power5", "geometric", "circular4_power52"])
def test_birkhoff_decomposition_matches_reference(m, which):
    """The same permutations in the same order, weights within 1e-12,
    and the decomposition reconstructs H."""
    if which == "geometric":
        h = J.random_geometric_mixing_matrix(m, 0.4, seed=1)
    elif which == "ring2_power5":
        h = np.linalg.matrix_power(J.circular_mixing_matrix(m, 2), 5)
    else:
        h = np.linalg.matrix_power(J.circular_mixing_matrix(m, 4), 52)
    perms, weights = T.birkhoff_decomposition(h)
    perms_ref, weights_ref = J.birkhoff_decomposition(h)
    assert len(perms) == len(perms_ref)
    assert all(np.array_equal(a, b) for a, b in zip(perms, perms_ref))
    np.testing.assert_allclose(weights, weights_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(sum(w * p for w, p in zip(weights, perms)), h,
                               rtol=0, atol=BIRKHOFF_RESIDUAL)
    _same_schedule(T.birkhoff_schedule(h), J.birkhoff_schedule(h), "birkhoff_schedule")


def test_the_papers_network():
    """The degree-4 circular network of M=20 at tolerance 1e-8: B = 52,
    compressed to 19 weighted hops (416 serial ones)."""
    h = T.circular_mixing_matrix(20, 4)
    np.testing.assert_array_equal(h, J.circular_mixing_matrix(20, 4))
    b = T.gossip_rounds_for_tolerance(h, 1e-8)
    assert b == J.gossip_rounds_for_tolerance(h, 1e-8) == 52
    assert abs(T.spectral_gap(h) - J.spectral_gap(h)) <= TOL
    sched = T.compressed_schedule(T.Ring(4), 20, b)
    assert len(sched.perms) == 19
    assert T.Ring(4).edges_per_node(20) * b == 416
    np.testing.assert_allclose(sched.as_matrix(), np.linalg.matrix_power(h, b),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", WORKERS)
def test_legacy_helpers_match_reference(m):
    for d in (1, 2, 4):
        np.testing.assert_array_equal(T.circular_mixing_matrix(m, d),
                                      J.circular_mixing_matrix(m, d))
        assert [T.circular_neighbors(i, m, d) for i in range(m)] == [
            J.circular_neighbors(i, m, d) for i in range(m)]
    np.testing.assert_array_equal(T.fully_connected_mixing_matrix(m),
                                  J.fully_connected_mixing_matrix(m))
    if m >= 2:
        g = T.random_geometric_mixing_matrix(m, 0.5, seed=2)
        np.testing.assert_array_equal(g, J.random_geometric_mixing_matrix(m, 0.5, seed=2))
        assert abs(T.spectral_gap(g) - J.spectral_gap(g)) <= TOL
        h = T.circular_mixing_matrix(m, 1)
        assert T.gossip_rounds_for_tolerance(h, 1e-6) == J.gossip_rounds_for_tolerance(h, 1e-6)
    assert _outcome(lambda: T.circular_mixing_matrix(0, 1)) == _outcome(
        lambda: J.circular_mixing_matrix(0, 1))


@pytest.mark.parametrize("bad", [
    np.ones((2, 3)) / 3, np.array([[1.5, -0.5], [-0.5, 1.5]]),
    np.array([[0.5, 0.5], [0.25, 0.75]]), np.array([[0.5, 0.25], [0.5, 0.75]]),
])
def test_check_doubly_stochastic_refuses_like_reference(bad):
    assert _outcome(lambda: T.check_doubly_stochastic(bad)) == _outcome(
        lambda: J.check_doubly_stochastic(bad))


PARSE_SPECS = [
    "ring", "ring:3", "torus:2x4", "torus:4x5", "hypercube", "geometric:0.5",
    "geometric:0.3:7", "full", "ring:1+hypercube", "ring:2+torus:2x4+full",
    # error paths
    "ring:1:2", "ring:x", "torus:5", "torus", "torus:2x", "hypercube:3", "geometric",
    "geometric:1:2:3", "geometric:-1", "full:2", "mobius", "ring:0", "torus:1x4",
    "ring:1+ring:1+timevarying",
]


@pytest.mark.parametrize("spec", PARSE_SPECS)
def test_parse_topology_matches_reference(spec):
    got, want = _outcome(lambda: T.parse_topology(spec)), _outcome(lambda: J.parse_topology(spec))
    if want[0] == "raise":
        assert got == want
    else:
        assert got[0] == "ok" and repr(got[1]) == repr(want[1])
        assert got[1] == T.parse_topology(spec) and hash(got[1]) == hash(T.parse_topology(spec))


def test_value_objects_and_their_refusals():
    assert T.Ring(2) == T.Ring(2) != T.Ring(1)
    assert len({T.Ring(2), T.Ring(2), T.Torus(2, 2), T.Torus(2, 2)}) == 2
    tv = T.TimeVarying((T.Ring(1), T.Hypercube()))
    assert tv.cycle() == (T.Ring(1), T.Hypercube()) and hash(tv) == hash(
        T.TimeVarying((T.Ring(1), T.Hypercube())))
    mem = T.Membership((1, 1, 0, 1))
    assert mem.active == (True, True, False, True) and mem.describe() == "1101"
    assert mem.num_active == 3 and mem.without(0).describe() == "0101"
    assert mem.rejoin(2) == T.Membership.all(4)
    assert T.Masked(T.Ring(1), mem) == T.Masked(T.Ring(1), T.Membership((1, 1, 0, 1)))
    for build in [
        lambda t: t.TimeVarying(()),
        lambda t: t.TimeVarying((t.Ring(1), "ring")),
        lambda t: t.TimeVarying((t.TimeVarying((t.Ring(1),)),)),
        lambda t: t.Masked("ring", t.Membership((1, 1))),
        lambda t: t.Masked(t.TimeVarying((t.Ring(1),)), t.Membership((1, 1))),
        lambda t: t.Masked(t.Ring(1), (1, 1)),
        lambda t: t.Membership(()),
        lambda t: t.Membership((0, 0)),
        lambda t: t.Membership((1, 1)).without(5),
        lambda t: t.Membership.all(0),
        lambda t: t.RandomGeometric(0.0),
        lambda t: t.Masked(t.Ring(1), t.Membership((1, 1, 1))).mixing_matrix(4),
        lambda t: t.Masked(t.TimeVarying((t.Ring(1),)).cycle()[0],
                           t.Membership((1,) * 5)).edges_per_node(None),
        lambda t: t.TimeVarying((t.Ring(1),)).exchange_schedule(4),
        lambda t: t.Ring(1).power_schedule(4, 0),
        lambda t: t.ExchangeSchedule(3, (), (), 1.0).compose(
            t.ExchangeSchedule(4, (), (), 1.0)),
        lambda t: t.gossip_rounds_for_tolerance(np.eye(3)),
    ]:
        got, want = _outcome(lambda: build(T)), _outcome(lambda: build(J))
        assert want[0] == "raise" and got == want


def test_compose_and_compress_match_reference():
    a_t, a_j = T.Ring(1).exchange_schedule(6), J.Ring(1).exchange_schedule(6)
    b_t, b_j = T.Ring(2).exchange_schedule(6), J.Ring(2).exchange_schedule(6)
    _same_schedule(a_t.compose(b_t), a_j.compose(b_j), "compose")
    _same_schedule(a_t.compose(b_t).compress(), a_j.compose(b_j).compress(), "compress")
    np.testing.assert_allclose(a_t.compose(b_t).as_matrix(),
                               b_t.as_matrix() @ a_t.as_matrix(), rtol=0, atol=1e-12)
    _same_schedule(T.cached_exchange_schedule(T.Torus(2, 3), 6),
                   J.cached_exchange_schedule(J.Torus(2, 3), 6), "cached")
