"""The port's MoE FFN (``repro_torch.nn.moe``) against ``repro.nn.moe`` on
the CPU.

The same numpy inputs (made from seeds) go through ``repro``'s
``moe_ffn`` (its plain path: no mesh) and the port's, at B=2, with drops
(``capacity_factor`` 0.5) and without (factor E), in f32 and in bf16.
Routing is held exactly: the expert ids, the capacity positions and the
keep masks of ``repro``'s ``_route_one`` (vmapped over B, as its
``_moe_core`` runs it) equal the port's ``route``.

Tolerances: f32 ``out`` within 1e-6 x max|out| (the same routing, and
expert products of d or f terms summed in other orders: a few ulps of the
largest output); bf16 ``out`` within 1e-2 x max|out| (the two frameworks
round the bf16 expert products and the SiLU at different places, 2**-8
relative each, and the down product sums f of them); the gates,
``load``, ``aux_loss`` and ``dropped`` within 1e-6 (a softmax of router
logits summed in other orders, a few f32 ulps of values <= 1, and counts
of the same routing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jmoe
from repro_torch.nn import moe

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
OUT_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
STATS_TOL = 1e-6
B, S, D, F, E, K = 2, 64, 32, 48, 4, 2


def _inputs(seed, b=B, s=S, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, router, wg, wu, wd


def _both(arrays, dtype):
    """The inputs for each package: the router stays f32, as the models keep it."""
    jdt, tdt = DTYPES[dtype]
    x, router, *w = arrays
    j = [jnp.asarray(x).astype(jdt), jnp.asarray(router)] + [jnp.asarray(a).astype(jdt) for a in w]
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(router)] + [
        torch.from_numpy(a).to(tdt) for a in w]
    return j, t


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _reference_routing(jx, jrouter, cap):
    """repro's per-sequence routing, vmapped over B as ``_moe_core`` runs it."""
    _, meta, _ = jax.vmap(lambda xs: jmoe._route_one(
        xs, jrouter, num_experts=jrouter.shape[1], top_k=K, cap=cap))(jx)
    ids, pos, gates, keep, _ = (np.asarray(m) for m in meta)
    return ids, pos, gates, keep


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 4.0, 8.0])
def test_capacity_matches_reference(factor):
    for s in (1, 7, 48, 64, 100, 1500, 4608, 8192):
        for e in (4, 8, 16):
            for k in (1, 2):
                assert moe.capacity(s, e, k, factor) == jmoe.capacity(s, e, k, factor)
    assert moe.capacity(8192, 16, 2, 1.25) == 1280      # Phi-3.5-MoE at S = 8192
    assert moe.capacity(8192, 8, 2, 1.25) == 2560       # Mixtral-8x22B at S = 8192


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [0.5, float(E)])
def test_moe_ffn_matches_reference(factor, dtype):
    """Routing ids, positions and keep masks equal; out and the stats
    within the module's bars; with factor 0.5 some assignments drop."""
    j, t = _both(_inputs(seed=int(factor * 10) + len(dtype)), dtype)
    want, jstats = jmoe.moe_ffn(*j, top_k=K, capacity_factor=factor)
    got, stats = moe.moe_ffn(*t, top_k=K, capacity_factor=factor)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, D)

    cap = moe.capacity(S, E, K, factor)
    plan, _ = moe.route(t[0], t[1], top_k=K, cap=cap)
    ids, pos, gates, keep = _reference_routing(j[0], j[1], cap)
    assert np.array_equal(plan.ids.numpy(), ids)
    assert np.array_equal(plan.slot.numpy(), np.minimum(pos, cap - 1))
    assert np.array_equal(plan.keep.numpy(), keep)
    np.testing.assert_allclose(plan.gates.numpy(), gates, atol=STATS_TOL)
    assert (float(jstats.dropped) > 0.0) == (factor < 1)

    got, want = _f32(got), _f32(want)
    assert np.abs(got - want).max() <= OUT_TOL[dtype] * np.abs(want).max()
    np.testing.assert_allclose(stats.load.numpy(), np.asarray(jstats.load), atol=STATS_TOL)
    assert abs(float(stats.aux_loss) - float(jstats.aux_loss)) <= STATS_TOL
    assert abs(float(stats.dropped) - float(jstats.dropped)) <= STATS_TOL


@pytest.mark.parametrize("pair", [(0, 1), (1, 3)])
def test_router_ties_go_to_the_lower_expert_index(pair):
    """Two equal router columns give every token two equal probabilities:
    the lower index is picked first, as ``jax.lax.top_k`` picks it."""
    x, router, wg, wu, wd = _inputs(seed=7)
    lo, hi = pair
    router[:, hi] = router[:, lo]
    x[..., 0] = 1.0
    router[0, [c for c in range(E) if c not in pair]] -= 50.0   # the pair wins everywhere
    j, t = _both((x, router, wg, wu, wd), "float32")
    cap = moe.capacity(S, E, K, float(E))
    plan, _ = moe.route(t[0], t[1], top_k=K, cap=cap)
    ids = plan.ids.reshape(B, S, K)
    assert (ids[..., 0] == lo).all() and (ids[..., 1] == hi).all()
    assert np.array_equal(plan.ids.numpy(), _reference_routing(j[0], j[1], cap)[0])
    want, _ = jmoe.moe_ffn(*j, top_k=K, capacity_factor=float(E))
    got, _ = moe.moe_ffn(*t, top_k=K, capacity_factor=float(E))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * np.abs(np.asarray(want)).max()


def test_moe_matches_dense_expert_sum():
    """``repro``'s test on the port: with capacity high enough for zero
    drops, the MoE output equals the explicit gate-weighted expert sum."""
    b, s, d, f, e, k = 2, 16, 8, 12, 4, 2
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(0, b, s, d, f, e))
    out, stats = moe.moe_ffn(x, router, wg, wu, wd, top_k=k, capacity_factor=float(e))
    assert float(stats.dropped) == 0.0

    probs = torch.softmax(x @ router, -1)
    gates, ids = torch.topk(probs, k)
    gates = gates / gates.sum(-1, keepdim=True)
    expert_out = torch.stack(
        [torch.nn.functional.silu(x @ wg[i]) * (x @ wu[i]) @ wd[i] for i in range(e)], dim=2
    )  # (b, s, e, d)
    weights = torch.nn.functional.one_hot(ids, e).float() * gates[..., None]
    want = torch.einsum("bske,bsed->bsd", weights, expert_out)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-4)


def test_moe_capacity_drops_tokens():
    """``repro``'s test on the port: capacity factor 0.5 drops
    assignments, the output stays finite and the aux loss positive."""
    b, s, d, f, e = 1, 64, 8, 8, 4
    rng = np.random.default_rng(1)
    x, router, wg, wu, wd = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                             for shape in ((b, s, d), (d, e), (e, d, f), (e, d, f), (e, f, d)))
    out, stats = moe.moe_ffn(x, router, wg, wu, wd, top_k=2, capacity_factor=0.5)
    assert float(stats.dropped) > 0.0
    assert bool(torch.isfinite(out).all())
    assert float(stats.aux_loss) > 0.0


def test_routing_is_batch_local():
    """Each sequence routes and fills its own buffers: the batched call
    equals one call per sequence, bit for bit, and the stats average them."""
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(seed=3, b=3))
    out, stats = moe.moe_ffn(x, router, wg, wu, wd, top_k=K, capacity_factor=0.75)
    ones = [moe.moe_ffn(x[i:i + 1], router, wg, wu, wd, top_k=K, capacity_factor=0.75)
            for i in range(3)]
    assert all(torch.equal(out[i:i + 1], o) for i, (o, _) in enumerate(ones))
    loads = torch.stack([st.load for _, st in ones]).mean(0)
    assert torch.allclose(stats.load, loads, atol=1e-7)
    assert abs(float(stats.dropped) - np.mean([float(st.dropped) for _, st in ones])) < 1e-7


def test_dropped_assignments_contribute_nothing():
    """A dropped assignment's gate is zeroed in the combine: the output of
    a token whose every assignment dropped is exactly zero."""
    x, router, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(seed=4, b=1))
    x[..., 0] = 1.0
    router[0, 1:] -= 100.0      # every token's choice is expert 0
    out, stats = moe.moe_ffn(x, router, wg, wu, wd, top_k=1, capacity_factor=0.125)
    cap = moe.capacity(S, E, 1, 0.125)
    assert cap == 8 and abs(float(stats.dropped) - (1 - cap / S)) < 1e-7
    assert out[0, cap:].abs().max() == 0.0 and out[0, :cap].abs().max() > 0.0
