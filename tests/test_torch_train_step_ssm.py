"""The port's train step against ``repro``'s on the CPU: the Zamba2 hybrid,
xLSTM and the bf16 dense transformer (``test_torch_train_step.py`` holds
the other f32 families and the guard).

``repro``'s seeded weights are carried across, the same numpy batch (B=2,
S=32) goes through both, and the port's ``make_train_step`` (AdamW 1e-3)
is held against ``jax.value_and_grad`` of ``repro``'s loss, compiled once
per case for the module, with remat on in both packages.  Bars: loss and
``grad_norm`` within 1e-5 relative; every xLSTM gradient leaf within 1e-4
x max|leaf|.  The reduced hybrid amplifies rounding in its gradient as in
its logits (``test_torch_hybrid.py``): one ulp up on every embedding
moves the port's own gradient by more than 1e-4 x max of some leaf
(``test_hybrid_gradient_amplifies_rounding``; measured 1.48e-4, and
1.55e-4 from ``repro``'s), so its leaves are held to 5e-4 x max and a
single Mamba2 layer's vector-Jacobian product to 1e-5.  bf16: the loss
within 1e-2 relative and each leaf's relative Frobenius gap under 5e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import blocks as j_blocks
from repro.models import build_model as j_build_model
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.convert import (
    hybrid_params_from_numpy,
    transformer_params_from_numpy,
    xlstm_params_from_numpy,
)
from repro_torch.models import blocks, build_model
from repro_torch.models.steps import make_grad_fn, make_train_step
from repro_torch.optim import AdamW

CASES = {
    "hybrid": ("zamba2_2_7b", {"remat": True}, hybrid_params_from_numpy),
    "xlstm": ("xlstm_350m", {"remat": True}, xlstm_params_from_numpy),
    "dense_bf16": ("h2o_danube3_4b", {"dtype": "bfloat16"}, transformer_params_from_numpy),
}
B, S = 2, 32
LOSS_REL = 1e-5
GRAD_REL = {"xlstm": 1e-4, "hybrid": 5e-4}
LAYER_REL = 1e-5
BF16_LOSS_REL = 1e-2
BF16_FRO_REL = 5e-2


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "labels": rng.integers(0, cfg.vocab_size, (B, S))}


def _torch_batch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


def _configs(case):
    arch, over, _ = CASES[case]
    return (dataclasses.replace(j_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@functools.cache
def _reference(case):
    """repro's params (numpy), the batch, its loss, grad norm and gradient
    leaves (f32 numpy, ``jax.tree.leaves`` order)."""
    jcfg, cfg = _configs(case)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)

    @jax.jit
    def loss_and_grads(params, b):
        loss, grads = jax.value_and_grad(j_make_loss_fn(jmodel))(params, b)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(grads)))
        return loss, gnorm, grads

    loss, gnorm, grads = loss_and_grads(
        jparams, {k: jnp.asarray(a, jnp.int32) for k, a in batch.items()})
    return (jax.tree.map(np.asarray, jparams), batch, float(loss), float(gnorm),
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


def _params(case):
    tree = _reference(case)[0]
    return CASES[case][2](tree, _configs(case)[1], device="cpu")


def _close_rel(got, want, rel):
    assert abs(got - want) <= rel * abs(want), (got, want, abs(got - want) / abs(want))


def _leaf_gaps(got, want):
    """Each leaf's max |got - want| / max|want|."""
    got = _tree.leaves(got)
    assert len(got) == len(want)
    gaps = []
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape
        gaps.append(float(np.abs(g - w).max()) / float(np.abs(w).max()))
    return gaps


class _Capture(AdamW):
    """AdamW that keeps the gradient tree it is given."""

    def update(self, params, grads, state):
        self.grads = grads
        return super().update(params, grads, state)


@pytest.mark.parametrize("case", ["hybrid", "xlstm"])
def test_train_step_matches_reference(case):
    _, batch, loss_ref, gnorm_ref, grads_ref = _reference(case)
    model = build_model(_configs(case)[1])
    opt = _Capture(lr=1e-3)
    stepped = _params(case)
    stepped, state, metrics = make_train_step(model, opt)(stepped, opt.init(stepped),
                                                         _torch_batch(batch))
    _close_rel(float(metrics["loss"]), loss_ref, LOSS_REL)
    _close_rel(float(metrics["grad_norm"]), gnorm_ref, LOSS_REL)
    assert max(_leaf_gaps(opt.grads, grads_ref)) <= GRAD_REL[case]
    # The step is one AdamW update of that gradient, bit for bit.
    params = _params(case)
    want, _ = AdamW(lr=1e-3).update(params, opt.grads, AdamW(lr=1e-3).init(params))
    for a, b in zip(_tree.leaves(stepped), _tree.leaves(want)):
        assert torch.equal(a, b)


def test_hybrid_gradient_amplifies_rounding():
    """Why the hybrid's leaves are held to 5e-4: moving every embedding
    element up by one f32 ulp moves the port's own gradient by more than
    1e-4 x max of some leaf (measured 1.48e-4), while a single layer holds
    1e-5."""
    _, batch, _, _, _ = _reference("hybrid")
    model = build_model(_configs("hybrid")[1])
    _, base = make_grad_fn(model)(_params("hybrid"), _torch_batch(batch))
    noisy = _params("hybrid")
    with torch.no_grad():
        embed = noisy["embed"]
        embed.copy_(torch.nextafter(embed, torch.full_like(embed, float("inf"))))
    _, moved = make_grad_fn(model)(noisy, _torch_batch(batch))
    gaps = _leaf_gaps(moved, [g.detach().numpy() for g in _tree.leaves(base)])
    assert 1e-4 < max(gaps) < GRAD_REL["hybrid"] / 2, max(gaps)


def test_mamba_layer_vjp_matches_reference():
    """One Mamba2 layer's vector-Jacobian product, for the first layer's
    params and for its input, within 1e-5 x max of ``repro``'s."""
    jcfg, cfg = _configs("hybrid")
    tree = _reference("hybrid")[0]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jlayer = {k: jnp.asarray(v[0, 0]) for k, v in tree["mamba"].items()}

    @jax.jit
    def layer_vjp(p, xx, ct):
        out, vjp = jax.vjp(lambda p_, x_: j_blocks.apply_mamba_layer(p_, x_, jcfg, None)[0],
                           p, xx)
        return out, vjp(ct)

    out, (jgrads, jgx) = layer_vjp(jlayer, jnp.asarray(x), jnp.asarray(cot))
    layer = {k: v[0, 0].clone().requires_grad_() for k, v in _params("hybrid")["mamba"].items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, _ = blocks.apply_mamba_layer(layer, tx, cfg, None)
    keys = sorted(layer)
    got = torch.autograd.grad(y, [layer[k] for k in keys] + [tx], torch.from_numpy(cot))
    want = [np.asarray(jgrads[k]) for k in keys] + [np.asarray(jgx)]
    assert float(np.abs(y.detach().numpy() - np.asarray(out)).max()) <= (
        LAYER_REL * float(np.abs(np.asarray(out)).max()))
    assert max(_leaf_gaps(list(got), want)) <= LAYER_REL


@pytest.mark.parametrize("case", ["hybrid", "xlstm"])
def test_remat_gradients_are_bit_equal(case):
    """Remat of each period recomputes the same ops: the gradients equal
    the no-remat ones bit for bit."""
    _, batch, _, _, _ = _reference(case)
    cfg = _configs(case)[1]
    results = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        results.append(make_grad_fn(model)(_params(case), _torch_batch(batch)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(g0), _tree.leaves(g1)))


def test_bf16_train_step_matches_reference():
    """bf16 rounds at 2**-8 in both packages, in different orders: the loss
    within 1e-2 relative, each gradient leaf's relative Frobenius gap
    under 5e-2 (measured: loss 3.1e-4, grad_norm 5.3e-4, leaves up to
    1.8e-2)."""
    _, batch, loss_ref, gnorm_ref, grads_ref = _reference("dense_bf16")
    model = build_model(_configs("dense_bf16")[1])
    params = _params("dense_bf16")
    opt = _Capture(lr=1e-3)
    params, state, metrics = make_train_step(model, opt)(
        params, opt.init(params), _torch_batch(batch))
    _close_rel(float(metrics["loss"]), loss_ref, BF16_LOSS_REL)
    _close_rel(float(metrics["grad_norm"]), gnorm_ref, BF16_FRO_REL)
    assert all(p.dtype == torch.bfloat16 for p in _tree.leaves(params))
    assert all(t.dtype == torch.float32 for t in _tree.leaves(state["m"]))
    for g, w in zip(_tree.leaves(opt.grads), grads_ref):
        assert g.dtype == torch.bfloat16
        gap = float(np.linalg.norm(g.float().numpy() - w) / np.linalg.norm(w))
        assert gap < BF16_FRO_REL, gap
