"""The port's Zamba2-style hybrid against ``repro``'s on the CPU.

``repro``'s seeded weights are carried across with
``convert.hybrid_params_from_numpy`` (the two packages draw different
random numbers), the same numpy tokens go through both, and the port's
forward (kernel route and plain route), loss, prefill and decode are held
against ``repro``'s.

Config: Zamba2-2.7B reduced to 12 layers, so two periods of six Mamba2
layers each followed by the shared attention block (two calls of one
weight-tied layer, two KV caches); d_model 256, 4 heads of 64, d_inner 512
(4 SSM heads of 128), state 16, window 64, chunk 16, f32.  ``repro``'s
kernel route runs its Pallas ``ssm_scan`` (and, at S % 128 == 0, its
``flash_attention``) in interpret mode.

Tolerances.  Each layer agrees with ``repro``'s to about 1e-6 of its
output on the same input (``test_torch_ssm_scan.py`` holds a Mamba layer
to 1e-5), but this random-weight model amplifies rounding about 1.5x per
layer: one-ulp noise on its embeddings moves its f32 logits by 1.6e-4 x
max|logits| (``test_reduced_model_amplifies_rounding``), and the
frameworks' own roundings land at 2.5e-4.  So whole-model f32 results
(logits, the loss, the caches) are held within 2e-3 x max|want|, about
ten times the model's response to one ulp.  In bf16 the amplified
roundings reach O(1) in the logits, so the bf16 forward is held by its
loss, within 1e-2 relative (measured 2e-3).  The port's routes and steps against each
other: the kernel route against the plain one, 1e-5 x max|logits| (the
same arithmetic on the CPU but for attention's summation order), and
prefill and decode against the full forward, ``test_arch_smoke.py``'s
1e-3.
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
from repro_torch.configs import get_config
from repro_torch.convert import (
    hybrid_param_shapes,
    hybrid_params_from_numpy,
    hybrid_params_to_numpy,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.models import build_model
from repro_torch.models.hybrid_model import HybridModel
from repro_torch.models.steps import make_loss_fn

LAYERS = 12
WHOLE = 2e-3     # whole-model f32 results against repro's (see above)


def _configs(**over):
    return (dataclasses.replace(j_get_config("zamba2_2_7b").reduced(layers=LAYERS), **over),
            dataclasses.replace(get_config("zamba2_2_7b").reduced(layers=LAYERS), **over))


@functools.cache
def _reference(dtype="float32"):
    """repro's model, its params and the port's copy of them."""
    jcfg, cfg = _configs(dtype=dtype)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, hybrid_params_from_numpy(tree, cfg, device="cpu")


def _tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _np32(got), _np32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


# ------------------------------------------------------------ build, convert


def test_build_model_gives_the_hybrid_at_full_and_reduced_width():
    full = build_model(get_config("zamba2_2_7b"))
    assert isinstance(full, HybridModel)
    assert (full.num_periods, full.per_period) == (9, 6)
    _, cfg = _configs()
    small = build_model(cfg)
    assert (small.num_periods, small.per_period) == (2, 6)
    assert cfg.d_inner_eff // cfg.ssm_heads == 128 and cfg.window == 64
    with pytest.raises(ValueError, match="shared_attn_period"):
        HybridModel(dataclasses.replace(cfg, num_layers=10))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_shapes_and_dtypes_match_init_and_reference(dtype):
    jcfg, cfg = _configs(dtype=dtype)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    shapes = hybrid_param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == shapes
    jdt = jax.tree.map(lambda a: "float32" if a.dtype == jnp.float32 else "bfloat16", jparams)
    tdt = jax.tree.map(lambda a: "float32" if a.dtype == torch.float32 else "bfloat16", port)
    assert tdt == jdt
    assert port["mamba"]["a_log"].dtype == torch.float32
    assert port["mamba"]["dt_bias"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_through_numpy(dtype):
    """Including a_log and dt_bias, which stay f32 under a bf16 config."""
    _, jparams, params = _reference(dtype)
    _, cfg = _configs(dtype=dtype)
    back = hybrid_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.tree.map(np.asarray, jparams))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == np.float32 and np.array_equal(got, w)
    again = hybrid_params_from_numpy(back, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(again):
        keys = tuple(k.key for k in path)
        f32 = keys in (("mamba", "a_log"), ("mamba", "dt_bias"))
        assert leaf.dtype == (torch.float32 if f32 else cfg.torch_dtype), keys
    # An explicit dtype casts every other leaf, never the two rates.
    forced = hybrid_params_from_numpy(back, cfg, device="cpu", dtype=torch.bfloat16)
    assert forced["mamba"]["a_log"].dtype == torch.float32
    assert forced["mamba"]["in_x"].dtype == torch.bfloat16


def test_convert_refuses_a_tree_of_another_config():
    _, jparams, _ = _reference()
    tree = jax.tree.map(np.asarray, jparams)
    _, other = _configs(ssm_state=8)
    with pytest.raises(ValueError, match=r"\['mamba'\]\['in_b'\]: expected shape"):
        hybrid_params_from_numpy(tree, other, device="cpu")
    _, cfg = _configs()
    with pytest.raises(ValueError, match="expected keys"):
        hybrid_params_from_numpy(dict(tree, extra=tree["ln_f"]), cfg, device="cpu")


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("s", [128, 100])
def test_forward_and_loss_match_reference(s, kernels):
    """Both packages through their kernel route and their plain route; at
    S = 100 every Mamba layer pads its scan to whole chunks."""
    jmodel, jparams, params = _reference()
    jcfg, cfg = _configs(use_pallas_kernels=kernels)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    toks, labels = _tokens(2, s, 1), _tokens(2, s, 2)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    want, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    before = (ss.launch_count(), fa.launch_count())
    with torch.no_grad():
        got, aux = model.forward(params, batch)
        loss = make_loss_fn(model)(params, batch)
    assert (ss.launch_count(), fa.launch_count()) == before   # the CPU takes the plain versions
    assert got.shape == (2, s, cfg.padded_vocab) and float(aux) == 0.0
    _close_scaled(got, want, WHOLE)
    jloss = float(jax.jit(j_make_loss_fn(jmodel))(jparams, jbatch))
    assert abs(float(loss) - jloss) <= WHOLE * abs(jloss)


def test_kernel_route_matches_plain_route():
    _, _, params = _reference()
    _, cfg = _configs()
    batch = {"tokens": torch.from_numpy(_tokens(2, 77, 4))}
    with torch.no_grad():
        plain, _ = build_model(cfg).forward(params, batch)
        routed, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=True)).forward(
            params, batch)
    _close_scaled(routed, plain, 1e-5)


def test_reduced_model_amplifies_rounding():
    """Why WHOLE is 2e-3: one-ulp relative noise on the embeddings moves
    the port's own f32 logits by more than 1e-5 x max|logits| (measured
    1.6e-4), while a single layer stays within 1e-5."""
    _, _, params = _reference()
    _, cfg = _configs()
    model = build_model(cfg)
    batch = {"tokens": torch.from_numpy(_tokens(2, 128, 1))}
    noise = torch.randn(params["embed"].shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        base, _ = model.forward(params, batch)
        moved, _ = model.forward(dict(params, embed=params["embed"] * (1 + 2**-24 * noise)),
                                 batch)
    gap = float((moved - base).abs().max() / base.abs().max())
    assert 1e-5 < gap < WHOLE / 5, gap


def test_bf16_forward_matches_reference():
    """bf16 rounds at 2**-8, which this model amplifies into logits that
    differ by O(1) between any two bf16 implementations (measured 0.68 x
    max|logits| against ``repro``'s); the loss, an average over all
    positions, stays within 1e-2 relative (measured 2e-3)."""
    _, jparams, params = _reference("bfloat16")
    jcfg, cfg = _configs(dtype="bfloat16", use_pallas_kernels=True)
    toks, labels = _tokens(2, 128, 1), _tokens(2, 128, 2)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    want = float(jax.jit(j_make_loss_fn(j_build_model(jcfg)))(jparams, jbatch))
    model = build_model(cfg)
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
        loss = float(make_loss_fn(model)(
            params, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    assert abs(loss - want) <= 1e-2 * abs(want), (loss, want)


# ---------------------------------------------------------- prefill/decode


@pytest.mark.parametrize("s,n0", [(48, 44), (73, 70), (20, 1)])
def test_prefill_and_decode_match_reference_and_forward(s, n0):
    """Prefill n0 tokens, then decode to s, against ``repro``'s prefill and
    decode steps and against the port's forward over all s tokens.  At
    n0 = 70 the prompt is past the window of 64, so each shared-attention
    cache stores the ring layout and decode writes over the oldest slots;
    a one-token prompt takes the decode recurrence from the zero state."""
    jmodel, jparams, params = _reference()
    _, cfg = _configs()
    model = build_model(cfg)
    toks = _tokens(2, s, 6)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n0])}, max_len=s)
    jlg, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=s))(
        jparams, {"tokens": jnp.asarray(toks[:, :n0])})
    slots = min(s, cfg.window)
    periods = LAYERS // cfg.shared_attn_period
    assert cache.attn.k.shape == (periods, 2, slots, cfg.num_kv_heads, cfg.hd)
    assert cache.attn.index.tolist() == [n0] * periods
    assert cache.ssm.h.shape == (periods, 6, 2, cfg.ssm_heads, 128, cfg.ssm_state)
    assert cache.ssm.h.dtype == torch.float32
    _close_scaled(cache.attn.k, jcache.attn.k, WHOLE)
    _close_scaled(cache.ssm.h, jcache.ssm.h, WHOLE)
    _close_scaled(cache.ssm.conv, jcache.ssm.conv, WHOLE)
    np.testing.assert_allclose(lg[:, -1].numpy(), full[:, n0 - 1].numpy(), atol=1e-3)
    _close_scaled(lg, jlg, WHOLE)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(n0, min(s, n0 + 3)):
        with torch.no_grad():
            lg, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                          cache)
        jlg, jcache = jstep(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=1e-3)
        _close_scaled(lg, jlg, WHOLE)
        _close_scaled(cache.ssm.h, jcache.ssm.h, WHOLE)
    assert cache.attn.index.tolist() == [min(s, n0 + 3)] * periods


def test_init_cache_matches_reference_layout():
    jmodel, _, _ = _reference()
    _, cfg = _configs()
    cache = build_model(cfg).init_cache(3, 200, device="cpu")
    jcache = jmodel.init_cache(3, 200)
    for got, want in ((cache.ssm.h, jcache.ssm.h), (cache.ssm.conv, jcache.ssm.conv),
                      (cache.attn.k, jcache.attn.k), (cache.attn.index, jcache.attn.index)):
        assert tuple(got.shape) == want.shape and not got.any()
    assert cache.ssm.h.dtype == torch.float32 and cache.attn.slots == 64
