"""``MeshBackend`` under every consensus policy: its mixes and ADMM solves
against repro's ``SimulatedBackend`` and the port's own, on the same
numpy inputs, at the reference's sim-vs-mesh geometry
(``tests/test_multidevice.py``: M=8, n=16, q=3, j=256, mu=1e-2, eps=6),
K=40 as its fault and Byzantine cases run (``:395, 508``).

The mesh is W=4 gloo ranks on the CPU (two workers a rank, one intra-op
thread each), spawned once for the module; every case runs in them in
turn.  Bars:

- Mixes (three in a row, the policy state carried): within MIX_TOL =
  1e-6 x max|x| of repro's, with its NaNs.  A mix that only moves
  messages is bit-equal to the port's simulated mix (a hop is an exact
  copy on either backend); one that reduces (exact, quantized, stale
  without a graph) sums per rank first, then across ranks, and is held
  to MIX_TOL.
- ADMM solves: ``o_star`` within 1e-4 of the port's simulated solve and
  of repro's, and the objective trace within rtol 1e-4
  (``test_multidevice.py:128-131``).  ``quantized:8`` is held at 2e-2 to
  either, and its K=300 solve at 5e-2 to the float64 oracle
  (``:152-162``): stochastic rounding turns the summation order's ulps
  into flipped draws.
- A second mesh solve, with the traces off, is bit-equal to the first (a
  fixed W fixes the order, ``test_multidevice.py:459, 535``; the iterate
  does not depend on tracing), and issues only the policy's mixes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import dssfn as tdssfn
from repro_torch.core import admm
from repro_torch.core import policy as tp
from repro_torch.core.backend import MeshBackend, SimulatedBackend
from repro_torch.launch.mesh import spawn_workers

M, N, Q, J = 8, 16, 3, 256
RANKS = 4
KW = dict(mu=1e-2, eps_radius=6.0, num_iters=40)
#: The quantized oracle solve's iterations, the reference's K there.
ORACLE_ITERS = 300
MIX_TOL = 1e-6
GAP = 1e-4
QUANT_GAP = 2e-2
QUANT_ORACLE = 5e-2

#: (id, spec in dssfn.parse_spec's grammar, serial): every policy family
#: of ALL_GRAMMAR and every topology kind.
CASES = [
    ("exact", "exact", False),
    ("ring", "gossip:6:2", False),
    ("ring-serial", "gossip:5:2", True),
    ("torus", "gossip:4@torus:2x4", False),
    ("hypercube", "gossip:4@hypercube", False),
    ("time-varying", "gossip:4@ring:1+hypercube", False),
    ("geometric", "gossip:4@geometric:0.5:1", False),
    ("bf16-wire", "gossip:4:2:wire=bf16", False),
    ("quantized", "quantized:8", False),
    ("quantized-ring", "quantized:8@ring:1", False),
    ("stale", "stale:2", False),
    ("stale-ring", "stale:1@ring:1", False),
    ("lossy", "lossy:0.1:3:1", False),
    ("async", "async:rounds=3:drop=0.2:seed=11@hypercube", False),
    ("async-interval", "async:rounds=2:interval=4:drop=0.1:stragglers=5:seed=7@ring:1", False),
    ("trimmed", "trimmed:f=1:rounds=3:byz=3:attack=signflip@torus:2x4", False),
    ("median", "median:rounds=2:byz=1:attack=nanbomb@ring:1", False),
    ("clipped", "clipped:0.5:byz=2:attack=scale:10", False),
]
IDS = [c[0] for c in CASES]
#: Policies whose mix reduces over the workers (no graph).
REDUCING = ("exact", "quantized", "stale")


def _policy(parse, spec, serial):
    pol = parse(spec)
    return dataclasses.replace(pol, compress=False) if serial else pol


def _inputs():
    rng = np.random.default_rng(0)
    y = rng.standard_normal((N, J)).astype(np.float32)
    t = rng.standard_normal((Q, J)).astype(np.float32)
    yw = np.ascontiguousarray(y.reshape(N, M, J // M).transpose(1, 0, 2))
    tw = np.ascontiguousarray(t.reshape(Q, M, J // M).transpose(1, 0, 2))
    xs = [rng.standard_normal((M, 4, 6)).astype(np.float32) for _ in range(3)]
    return y, t, yw, tw, xs


def _mixes(policy, xs, ctx, shard):
    """Three mixes in a row of the held rows of ``xs``, the state carried."""
    blocks = [shard(torch.from_numpy(x)) for x in xs]
    state = policy.init_state(blocks[0], ctx)
    outs = []
    for b in blocks:
        out, state = policy.mix(b, state, ctx)
        outs.append(out.numpy().copy())
    return outs


def _policy_rank(group, cases):
    """Every case on this rank: its mixes (the held block), an ADMM solve
    traced and one untraced (o_star, the objective trace, the
    collectives each issued), and the quantized oracle solve."""
    _, _, yw, tw, xs = _inputs()
    out = {}
    for name, spec, serial in cases:
        backend = MeshBackend(group, policy=_policy(tdssfn.parse_spec, spec, serial))
        mixes = _mixes(backend.policy, xs, backend.ctx(), backend.shard_workers)
        y_b = backend.shard_workers(torch.from_numpy(yw))
        t_b = backend.shard_workers(torch.from_numpy(tw))
        solves, counts = [], []
        for trace_every in (1, 0):
            backend.reset_collective_counts()
            solves.append(admm.admm_ridge_consensus(
                y_b, t_b, backend=backend, trace_every=trace_every, **KW))
            counts.append(backend.collective_counts())
        out[name] = {
            "mixes": mixes,
            "o_star": [s.o_star.numpy() for s in solves],
            "objective": solves[0].trace.objective.numpy(),
            "counts": counts,
        }
        if name == "quantized":
            out[name]["oracle_solve"] = admm.admm_ridge_consensus(
                y_b, t_b, backend=backend, trace_every=0,
                **{**KW, "num_iters": ORACLE_ITERS}).o_star.numpy()
    return out


@pytest.fixture(scope="module")
def mesh():
    """The ranks' results, each case's blocks joined in rank order."""
    per_rank = spawn_workers(
        _policy_rank, RANKS, CASES, num_workers=M, backend="gloo", device="cpu",
        threads=1, join_timeout_s=400,
    )
    joined = {}
    for name, _, _ in CASES:
        first = per_rank[0][name]
        joined[name] = {
            "mixes": [np.concatenate([r[name]["mixes"][i] for r in per_rank])
                      for i in range(3)],
            "o_star": first["o_star"],
            "objective": first["objective"],
            "oracle_solve": first.get("oracle_solve"),
            "counts": [r[name]["counts"] for r in per_rank],
            "ranks_agree": all(
                np.array_equal(r[name]["o_star"][0], first["o_star"][0]) for r in per_rank
            ),
        }
    return joined


def _close(got, want, x, tol=MIX_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin].astype(np.float64)).max(initial=0.0)
    assert err <= tol * np.abs(x).max(), err


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jmixes(policy, xs):
    """repro's three mixes of ``xs`` under vmap, the state carried."""
    import jax
    import jax.numpy as jnp

    from repro.core import policy as jp

    ctx = jp.ConsensusContext("w", M)

    def body(*xis):
        state = policy.init_state(xis[0], ctx)
        outs = []
        for xi in xis:
            y, state = policy.mix(xi, state, ctx)
            outs.append(y)
        return tuple(outs)

    return [np.asarray(o) for o in jax.vmap(body, axis_name="w")(*map(jnp.asarray, xs))]


@pytest.mark.parametrize("name,spec,serial", CASES, ids=IDS)
def test_mesh_mixes_match_reference_and_simulated(mesh, name, spec, serial):
    from repro import dssfn as jdssfn

    xs = _inputs()[4]
    got = mesh[name]["mixes"]
    want = _jmixes(_policy(jdssfn.parse_spec, spec, serial), xs)
    pol = _policy(tdssfn.parse_spec, spec, serial)
    sim = _mixes(pol, xs, tp.ConsensusContext(M), lambda t: t)
    for g, w, s, x in zip(got, want, sim, xs):
        _close(g, w, x)
        if name in REDUCING:
            _close(g, s, x)
        else:
            assert np.array_equal(g, s, equal_nan=True)


@pytest.mark.parametrize("name,spec,serial", CASES, ids=IDS)
def test_mesh_admm_matches_reference_and_simulated(mesh, name, spec, serial):
    import jax.numpy as jnp

    from repro import dssfn as jdssfn
    from repro.core import admm as jadmm
    from repro.core.backend import SimulatedBackend as JBackend

    y, t, yw, tw, _ = _inputs()
    got = mesh[name]
    pol = _policy(tdssfn.parse_spec, spec, serial)
    sim = admm.admm_ridge_consensus(
        torch.from_numpy(yw), torch.from_numpy(tw), backend=SimulatedBackend(M, policy=pol), **KW
    )
    jpol = _policy(jdssfn.parse_spec, spec, serial)
    ref = jadmm.admm_ridge_consensus(
        jnp.asarray(yw), jnp.asarray(tw), backend=JBackend(M, policy=jpol), **KW
    )
    bar = QUANT_GAP if name.startswith("quantized") else GAP
    assert got["ranks_agree"]
    assert np.array_equal(got["o_star"][0], got["o_star"][1])
    assert _rel(got["o_star"][0], sim.o_star.numpy()) < bar
    assert _rel(got["o_star"][0], np.asarray(ref.o_star)) < bar
    if name == "quantized":
        oracle = admm.exact_constrained_ridge(
            torch.from_numpy(y), torch.from_numpy(t), eps_radius=KW["eps_radius"]
        ).numpy()
        assert _rel(got["oracle_solve"], oracle) < QUANT_ORACLE
    if not name.startswith("quantized"):
        np.testing.assert_allclose(got["objective"], sim.trace.objective.numpy(), rtol=GAP)
        np.testing.assert_allclose(got["objective"], np.asarray(ref.trace.objective), rtol=GAP)


@pytest.mark.parametrize("name,spec,serial", CASES, ids=IDS)
def test_mesh_collectives_match_the_policy(mesh, name, spec, serial):
    """A solve of K iterations issues the policy's mixes (a reduction, or
    a collective-permute a hop); traced, also the traces' reductions; on
    every rank alike."""
    counts = mesh[name]["counts"]
    assert all(c == counts[0] for c in counts)
    pol = _policy(tdssfn.parse_spec, spec, serial)
    k = KW["num_iters"]
    mixes = k // pol.communication_interval
    traces = 2 if pol.is_exact else 4
    topo = getattr(pol, "topology", None)
    if topo is None:
        want = {"all-reduce": mixes}
    else:
        if isinstance(pol, tp.Gossip):
            hops = pol.hops_for(M)
        else:
            per_phase = [len(tp.topology_lib.cached_exchange_schedule(p, M).perms)
                         for p in topo.cycle()]
            rounds = 1 if isinstance(pol, tp.StaleMixing) else pol.rounds
            hops = sum(per_phase[b % len(per_phase)] for b in range(rounds))
        want = {"collective-permute": mixes * hops}
    # A solve gathers o_star and the jitter levels once, at its end.
    want["all-gather"] = 2
    traced, hot = counts[0]
    assert hot == want
    assert traced == {**want, "all-reduce": want.get("all-reduce", 0) + traces * k}
