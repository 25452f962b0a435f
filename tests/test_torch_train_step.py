"""The port's train step against ``repro``'s on the CPU: the dense, MoE, VLM
and audio transformers, the kernel ops' autograd guard, and one train
step of every config.

``repro``'s seeded weights are carried across with
``convert.transformer_params_from_numpy``, the same numpy batch
(``tests/test_arch_smoke.py``'s, B=2, S=32) goes through both, and the
port's ``make_train_step`` (AdamW 1e-3) is held against the reference's
loss and gradient: ``jax.value_and_grad`` of ``repro``'s
``make_loss_fn``, compiled once per family for the module, with the
gradient norm taken as ``repro``'s ``make_train_step`` takes it.  The
dense case runs the two-level remat (``remat=True, remat_block=1``) in
both packages.  Bars: loss and ``grad_norm`` within 1e-5 relative, every
gradient leaf within 1e-4 x max|leaf| (f32, reduced configs).  The hybrid,
xLSTM and the bf16 dense model are in ``test_torch_train_step_ssm.py``, so
that ``--dist loadfile`` shares the reference's compiles out.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import _tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gram import gram
from repro_torch.kernels.matmul_relu import matmul_relu
from repro_torch.kernels.mlstm_scan import mlstm_scan
from repro_torch.kernels.propagate_gram import propagate_gram
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import build_model
from repro_torch.models.steps import make_grad_fn, make_train_step
from repro_torch.optim import AdamW

FAMILIES = {
    "dense": ("h2o_danube3_4b", {"remat": True, "remat_block": 1}),
    "moe": ("phi35_moe_42b", {}),
    "vlm": ("internvl2_1b", {}),
    "audio": ("musicgen_medium", {}),
}
B, S = 2, 32
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _batch(cfg, b=B, s=S, seed=0):
    """``test_arch_smoke.py``'s batch as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        shape = (b, s, cfg.num_codebooks)
    else:
        shape = (b, s - cfg.num_patches if cfg.family == "vlm" else s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape),
           "labels": rng.integers(0, cfg.vocab_size, shape)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(size=(b, cfg.num_patches, cfg.patch_dim)).astype(
            np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(a, jnp.float32 if a.dtype.kind == "f" else jnp.int32)
            for k, a in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


@functools.cache
def _reference(case):
    """repro's params (numpy), the batch, and its loss, grad norm and
    gradient leaves (numpy, ``jax.tree.leaves`` order)."""
    arch, over = FAMILIES[case]
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)

    @jax.jit
    def loss_and_grads(params, b):
        loss, grads = jax.value_and_grad(j_make_loss_fn(jmodel))(params, b)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(grads)))
        return loss, gnorm, grads

    loss, gnorm, grads = loss_and_grads(jparams, _jax_batch(batch))
    return (cfg, jax.tree.map(np.asarray, jparams), batch, float(loss), float(gnorm),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


def _close_rel(got, want, rel):
    assert abs(got - want) <= rel * abs(want), (got, want, abs(got - want) / abs(want))


def _assert_grads_close(got, want, rel=GRAD_REL):
    got = _tree.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert g.shape == w.shape
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (err / float(np.abs(w).max()), g.shape)


class _Capture(AdamW):
    """AdamW that keeps the gradient tree it is given."""

    def update(self, params, grads, state):
        self.grads = grads
        return super().update(params, grads, state)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_train_step_matches_reference(case):
    cfg, tree, batch, loss_ref, gnorm_ref, grads_ref = _reference(case)
    model = build_model(cfg)
    opt = _Capture(lr=1e-3)
    stepped = transformer_params_from_numpy(tree, cfg, device="cpu")
    stepped, state, metrics = make_train_step(model, opt)(stepped, opt.init(stepped),
                                                         _torch_batch(batch))
    _close_rel(float(metrics["loss"]), loss_ref, LOSS_REL)
    _close_rel(float(metrics["grad_norm"]), gnorm_ref, LOSS_REL)
    _assert_grads_close(opt.grads, grads_ref)
    assert int(state["step"]) == 1
    # The step is one AdamW update of that gradient, bit for bit.
    params = transformer_params_from_numpy(tree, cfg, device="cpu")
    want, _ = AdamW(lr=1e-3).update(params, opt.grads, AdamW(lr=1e-3).init(params))
    for a, b in zip(_tree.leaves(stepped), _tree.leaves(want)):
        assert torch.equal(a, b)
    assert all(p.requires_grad and p.grad_fn is None for p in _tree.leaves(stepped))


def test_dense_remat_gradients_are_bit_equal():
    """Per-layer and two-level remat recompute the same ops: the
    gradients equal the no-remat ones bit for bit."""
    base = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), num_layers=4)
    batch = _torch_batch(_batch(base))
    results = []
    for over in ({"remat": False}, {"remat": True, "remat_block": 0},
                 {"remat": True, "remat_block": 1}, {"remat": True, "remat_block": 2}):
        cfg = dataclasses.replace(base, **over)
        model = build_model(cfg)
        results.append(make_grad_fn(model)(model.init(torch.Generator().manual_seed(0)), batch))
    (loss0, grads0), rest = results[0], results[1:]
    for loss, grads in rest:
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(grads), _tree.leaves(grads0)))


def test_second_step_continues_from_the_first():
    """The returned params and state feed the next step, and the loss on
    a repeated batch falls."""
    cfg = get_config("h2o_danube3_4b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = _torch_batch(_batch(cfg))
    losses = []
    for _ in range(3):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert int(state["step"]) == 3
    assert losses[2] < losses[1] < losses[0]


# ------------------------------------------------------------ the guard

_OPS = {
    "flash_attention": (flash_attention, lambda g: (
        (torch.randn(1, 2, 16, 8, generator=g), torch.randn(1, 2, 16, 8, generator=g),
         torch.randn(1, 2, 16, 8, generator=g)), {})),
    "gram": (gram, lambda g: ((torch.randn(1, 4, 8, generator=g),), {"mu": 1.0})),
    "matmul_relu": (matmul_relu, lambda g: (
        (torch.randn(4, 3, generator=g), torch.randn(3, 5, generator=g)), {})),
    "propagate_gram": (propagate_gram, lambda g: (
        (torch.randn(4, 3, generator=g), torch.randn(1, 3, 8, generator=g)), {"mu": 1.0})),
    "ssm_scan": (ssm_scan, lambda g: (
        (torch.randn(1, 16, 2, 4, generator=g), torch.rand(1, 16, 2, generator=g),
         -torch.rand(2, generator=g), torch.randn(1, 16, 4, generator=g),
         torch.randn(1, 16, 4, generator=g)), {"chunk": 16})),
    "mlstm_scan": (mlstm_scan, lambda g: (
        (torch.randn(1, 16, 2, 4, generator=g), torch.randn(1, 16, 2, 4, generator=g),
         torch.randn(1, 16, 2, 4, generator=g), torch.randn(1, 16, 2, generator=g),
         torch.randn(1, 16, 2, generator=g)), {"chunk": 16})),
}


@pytest.mark.parametrize("name", list(_OPS))
def test_kernel_op_refuses_tensors_that_require_grad(name):
    """Neither package has a backward for a kernel: each op raises, naming
    itself and the plain path, when autograd would record it, and runs
    under ``no_grad`` or on tensors that require no grad."""
    op, make = _OPS[name]
    args, kwargs = make(torch.Generator().manual_seed(0))
    op(*args, **kwargs)
    for i in range(len(args)):
        leaf_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match=f"{name} has no backward.*use_pallas_kernels=False"):
            op(*leaf_args, **kwargs)
        with torch.no_grad():
            op(*leaf_args, **kwargs)


@pytest.mark.parametrize("arch", ["h2o_danube3_4b", "zamba2_2_7b", "xlstm_350m"])
def test_train_step_with_kernels_raises(arch):
    """A model routed through the kernel ops cannot be trained, as
    ``repro``'s ``value_and_grad`` through its Pallas route raises."""
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt = AdamW(lr=1e-3)
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(model, opt)(params, opt.init(params), _torch_batch(_batch(cfg)))
    with torch.no_grad():      # scoring the same batch still runs
        logits, _ = model.forward(params, _torch_batch(_batch(cfg)))
    assert torch.isfinite(logits).all()


# ------------------------------------------ test_arch_smoke.py, ported


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_train_step(arch):
    cfg = get_config(arch).reduced()
    assert cfg.d_model <= 512 and cfg.num_experts <= 4
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_batch(cfg))
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
    if cfg.family == "audio":
        assert logits.shape == (B, S, cfg.num_codebooks, cfg.padded_vocab)
    else:
        assert logits.shape == (B, S, cfg.padded_vocab)
    assert torch.isfinite(logits.float()).all()

    before = [p.clone() for p in _tree.leaves(params)]
    opt = AdamW(lr=1e-3)
    params2, _, metrics = make_train_step(model, opt)(params, opt.init(params), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    delta = max(float((a.float() - b.detach().float()).abs().max())
                for a, b in zip(before, _tree.leaves(params2)))
    assert delta > 0
