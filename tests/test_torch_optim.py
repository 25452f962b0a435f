"""The port's optimizers against ``repro``'s on the CPU.

The same numpy params and gradients go through ``repro.optim`` and
``repro_torch.optim``; params and state must agree within 2 f32 ulps at
step 1 and at step 5, the latter started from ``repro``'s step-4 state
carried across with ``convert.opt_state_from_numpy``.  The last three
tests are ``tests/test_infra.py``'s optimizer tests, ported (bf16 params,
f32 moments).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import Sgd as JSgd
from repro_torch import _tree
from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.optim import AdamW, Sgd

SHAPES = {"w": (7, 5), "block": {"b": (13,), "k": (3, 4, 2)}}
CASES = {
    "sgd": ({"lr": 5e-2}, JSgd, Sgd),
    "sgd_momentum": ({"lr": 5e-2, "momentum": 0.9}, JSgd, Sgd),
    "adamw": ({"lr": 1e-3}, JAdamW, AdamW),
    "adamw_decay": ({"lr": 1e-3, "weight_decay": 0.1}, JAdamW, AdamW),
}
ULPS = 2


def _draw(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v) for k, v in shapes.items()}
    return rng.normal(size=shapes).astype(np.float32)


def _to_torch(tree):
    return _tree.map_(lambda a: torch.tensor(np.asarray(a)), tree)


def _ulps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    gi = got.view(np.int32).astype(np.int64)
    wi = want.view(np.int32).astype(np.int64)
    # Map the sign-magnitude bit patterns onto one ordered integer line.
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)
    wi = np.where(wi < 0, -(wi & 0x7FFFFFFF), wi)
    return int(np.abs(gi - wi).max())


def _assert_trees_close(got, want):
    got_leaves, want_leaves = _tree.leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if w.dtype == np.float32:
            assert _ulps(g, w) <= ULPS
        else:
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    return _draw(rng, SHAPES), [_draw(rng, SHAPES) for _ in range(5)]


@pytest.fixture(scope="module")
def reference(problem):
    """repro's (params, state) after each of five steps, per case."""
    params0, grads = problem
    out = {}
    for name, (kw, jopt_cls, _) in CASES.items():
        opt = jopt_cls(**kw)
        params = jax.tree.map(jnp.asarray, params0)
        state = opt.init(params)
        steps = []
        for g in grads:
            params, state = opt.update(params, jax.tree.map(jnp.asarray, g), state)
            steps.append((params, state))
        out[name] = steps
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_first_step_matches_reference(name, problem, reference):
    params0, grads = problem
    kw, _, opt_cls = CASES[name]
    opt = opt_cls(**kw)
    params = _to_torch(params0)
    new_params, state = opt.update(params, _to_torch(grads[0]), opt.init(params))
    want_params, want_state = reference[name][0]
    _assert_trees_close(new_params, want_params)
    _assert_trees_close(state, want_state)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()


@pytest.mark.parametrize("name", list(CASES))
def test_fifth_step_from_reference_state(name, problem, reference):
    """Step 5 from repro's step-4 params and state, carried across."""
    _, grads = problem
    kw, _, opt_cls = CASES[name]
    opt = opt_cls(**kw)
    params4, state4 = reference[name][3]
    params = _to_torch(jax.tree.map(np.asarray, params4))
    state = opt_state_from_numpy(jax.tree.map(np.asarray, state4), device="cpu")
    new_params, new_state = opt.update(params, _to_torch(grads[4]), state)
    want_params, want_state = reference[name][4]
    _assert_trees_close(new_params, want_params)
    _assert_trees_close(new_state, want_state)
    assert int(new_state["step"]) == 5


@pytest.mark.parametrize("name", list(CASES))
def test_opt_state_round_trips_through_numpy(name, reference):
    kw, _, opt_cls = CASES[name]
    state = jax.tree.map(np.asarray, reference[name][2][1])
    back = opt_state_to_numpy(opt_state_from_numpy(state, device="cpu"))
    _assert_trees_close(back, state)
    assert back["step"].dtype == np.int32


def test_update_writes_params_and_moments_in_place(problem):
    """The update returns the tensors it was given, rewritten: at published
    width a second copy of the moments would not fit beside the first."""
    params0, grads = problem
    opt = AdamW(lr=1e-3)
    params = _to_torch(params0)
    state = opt.init(params)
    ptrs = [t.data_ptr() for t in _tree.leaves(params) + _tree.leaves(state["m"])]
    new_params, new_state = opt.update(params, _to_torch(grads[0]), state)
    assert new_params is params
    assert [t.data_ptr() for t in
            _tree.leaves(new_params) + _tree.leaves(new_state["m"])] == ptrs
    assert not torch.equal(params["w"], torch.from_numpy(params0["w"]))


# ------------------------------------------------- test_infra.py, ported


def test_adamw_decreases_quadratic():
    opt = AdamW(lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(120):
        g = {"w": 2 * params["w"].detach()}
        params, state = opt.update(params, g, state)
    assert float(torch.sum(params["w"] ** 2)) < 0.05


def test_sgd_momentum():
    opt = Sgd(lr=0.05, momentum=0.9)
    params = {"w": torch.tensor(4.0)}
    state = opt.init(params)
    for _ in range(150):
        g = {"w": 2 * params["w"].clone()}
        params, state = opt.update(params, g, state)
    assert abs(float(params["w"])) < 0.1


def test_adamw_preserves_dtype():
    opt = AdamW(lr=1e-2)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = opt.init(params)
    g = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    new, state = opt.update(params, g, state)
    assert new["w"].dtype == torch.bfloat16
    assert state["m"]["w"].dtype == torch.float32
