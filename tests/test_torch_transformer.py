"""The port's dense transformer against ``repro``'s on the CPU.

``repro``'s seeded weights are carried across with
``convert.transformer_params_from_numpy`` (the two packages draw different
random numbers), the same numpy tokens go through both, and the port's
forward, loss, prefill and decode are held against ``repro``'s.

Configs: H2O-Danube3-4B reduced, with ``num_kv_heads=2`` so that GQA is
kept (``reduced()`` alone gives 4 KV heads for 4 heads), and a two-head
``head_dim=120`` variant with one KV head; StableLM-3B reduced for full
(non-window) attention.  The reduced window is 64.

Tolerances: f32 logits within 1e-5 x max|logits| (two layers of f32
matmuls and attention summed in other orders: a few ulps of the largest
logit); bf16 logits within 3e-2 x max|logits| (the two frameworks round
intermediate bf16 results at different places, 2**-8 relative each, and
two layers compound a few of them); the f32 loss within 1e-5 relative.  Prefill
and decode against the full forward: ``test_arch_smoke.py``'s 1e-3.
The kernel route against the plain one: ``test_kernel_integration.py``'s
5e-3.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import ALIASES as J_ALIASES
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro_torch import prng
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.convert import (
    transformer_param_shapes,
    transformer_params_from_numpy,
    transformer_params_to_numpy,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models.steps import cross_entropy, make_loss_fn, make_serve_step

CASES = {
    "h2o_gqa": ("h2o_danube3_4b", dict(num_kv_heads=2, attn_chunk=128)),
    "h2o_hd120": ("h2o_danube3_4b",
                  dict(num_heads=2, num_kv_heads=1, head_dim=120, attn_chunk=128)),
    "stablelm": ("stablelm_3b", dict(attn_chunk=128)),
}


def _configs(case, **extra):
    arch, over = CASES[case]
    over = dict(over, **extra)
    return (dataclasses.replace(j_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


@functools.cache
def _reference(case, dtype="float32"):
    """repro's model, its params and the port's copy of them."""
    jcfg, cfg = _configs(case, dtype=dtype)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, transformer_params_from_numpy(tree, cfg, device="cpu")


def _tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _np32(got), _np32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


# ---------------------------------------------------------------- configs


def test_configs_are_the_reference_configs():
    assert ARCHS == J_ARCHS and ALIASES == J_ALIASES
    for arch in ARCHS:
        jcfg, cfg = j_get_config(arch), get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert (cfg.hd, cfg.padded_vocab, cfg.sub_quadratic, cfg.d_inner_eff) == \
            (jcfg.hd, jcfg.padded_vocab, jcfg.sub_quadratic, jcfg.d_inner_eff)
    full = get_config("h2o-danube-3-4b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.hd,
            full.d_ff, full.padded_vocab, full.window) == (24, 3840, 32, 8, 120, 10240, 32000, 4096)
    assert full.torch_dtype == torch.bfloat16 and full.reduced().torch_dtype == torch.float32


def test_param_shapes_match_init_and_reference():
    jmodel, jparams, params = _reference("h2o_gqa")
    _, cfg = _configs("h2o_gqa")
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    shapes = transformer_param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == shapes
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(port))


# prng.normal is jax's normal to 2 f32 ulps; scaled by 1/sqrt(fan_in) (a
# binade boundary may double them) and rounded once more: at most 5 ulps.
KEY_INIT_ULPS = 5


@pytest.mark.parametrize("arch,dtype", [
    ("stablelm_3b", "float32"), ("stablelm_3b", "bfloat16"), ("phi35_moe_42b", "bfloat16"),
    ("internvl2_1b", "float32"), ("musicgen_medium", "float32")])
def test_init_from_a_key_is_the_reference_init(arch, dtype):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    want = j_build_model(jcfg).init(jax.random.PRNGKey(3))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # a few hundred small eager ops a leaf
    try:
        got = build_model(cfg).init(key=prng.PRNGKey(3), device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert str(g.dtype) == f"torch.{w.dtype}", path
        bf16 = w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if bf16:
            # An f32 draw a few ulps from a bf16 rounding boundary may
            # round to the neighbour: one bf16 ulp on a few elements.
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w)), path
            assert np.mean(g != w) < 1e-3, path
        else:
            assert np.all(np.abs(g - w) <= KEY_INIT_ULPS * np.spacing(np.abs(w))), path
    with pytest.raises(ValueError, match="exactly one"):
        build_model(cfg).init()


# ------------------------------------------------------------------ convert


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_through_numpy(dtype):
    jmodel, jparams, params = _reference("h2o_hd120", dtype)
    tree = jax.tree.map(np.asarray, jparams)
    back = transformer_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == np.float32 and np.array_equal(got, w)
    _, cfg = _configs("h2o_hd120", dtype=dtype)
    again = transformer_params_from_numpy(back, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)))
    assert all(t.dtype == cfg.torch_dtype for t in jax.tree.leaves(again))


def test_convert_refuses_a_tree_of_another_config():
    jmodel, jparams, params = _reference("h2o_gqa")
    tree = jax.tree.map(np.asarray, jparams)
    _, other = _configs("h2o_hd120")
    with pytest.raises(ValueError, match=r"\['layers'\]\['attn'\]\['wq'\]: expected shape"):
        transformer_params_from_numpy(tree, other, device="cpu")
    _, cfg = _configs("h2o_gqa")
    with pytest.raises(ValueError, match="expected keys"):
        transformer_params_from_numpy(dict(tree, extra=tree["ln_f"]), cfg, device="cpu")


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_reference(case, kernels):
    jmodel, jparams, params = _reference(case)
    jcfg, cfg = _configs(case, use_pallas_kernels=kernels)
    model = build_model(cfg)
    jmodel = j_build_model(jcfg)
    toks, labels = _tokens(2, 128, 1), _tokens(2, 128, 2)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    want, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    before = fa.launch_count()
    with torch.no_grad():
        got, aux = model.forward(params, batch)
        loss = make_loss_fn(model)(params, batch)
    assert fa.launch_count() == before          # the CPU takes the plain version
    assert got.shape == (2, 128, cfg.padded_vocab) and float(aux) == 0.0
    _close_scaled(got, want, 1e-5)
    jloss = float(jax.jit(j_make_loss_fn(jmodel))(jparams, jbatch))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)


@pytest.mark.parametrize("case", ["h2o_gqa", "h2o_hd120"])
def test_bf16_forward_matches_reference(case):
    jmodel, jparams, params = _reference(case, "bfloat16")
    jcfg, cfg = _configs(case, dtype="bfloat16", use_pallas_kernels=True)
    toks = _tokens(2, 128, 3)
    want, _ = jax.jit(j_build_model(jcfg).forward)(jparams, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, _ = build_model(cfg).forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    _close_scaled(got, want, 3e-2)


@pytest.mark.parametrize("s", [100, 77])
def test_kernel_route_matches_plain_route_at_ragged_lengths(s):
    """``repro`` falls back to the chunked path when S % 128 != 0; the
    port takes its flash_attention op at every S, with the same result."""
    _, _, params = _reference("h2o_gqa")
    _, cfg = _configs("h2o_gqa", attn_chunk=32)
    batch = {"tokens": torch.from_numpy(_tokens(2, s, 4))}
    with torch.no_grad():
        plain, _ = build_model(cfg).forward(params, batch)
        routed, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=True)).forward(
            params, batch)
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), atol=5e-3)
    _close_scaled(routed, plain, 1e-5)


def test_cross_entropy_matches_reference_with_ignored_labels():
    from repro.models.steps import cross_entropy as j_cross_entropy

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 6))
    labels[0, :4] = -1
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    all_ignored = cross_entropy(torch.from_numpy(logits), torch.full((2, 6), -1))
    assert float(all_ignored) == 0.0


# ---------------------------------------------------------- prefill/decode


@pytest.mark.parametrize("case,s,n0", [("h2o_gqa", 48, 44), ("h2o_gqa", 96, 80),
                                       ("h2o_hd120", 72, 66), ("stablelm", 48, 44)])
def test_prefill_and_decode_match_reference_and_forward(case, s, n0):
    """``test_arch_smoke.py``'s decode check in both packages.  At s=96
    the 80-token prompt exceeds the window of 64, so prefill stores the
    ring layout and decode writes over the oldest slots."""
    jmodel, jparams, params = _reference(case)
    _, cfg = _configs(case)
    model = build_model(cfg)
    toks = _tokens(2, s, 6)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n0])}, max_len=s)
    jlg, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=s))(
        jparams, {"tokens": jnp.asarray(toks[:, :n0])})
    slots = min(s, cfg.window) if cfg.attention == "swa" else s
    assert cache.k.shape == (cfg.num_layers, 2, slots, cfg.num_kv_heads, cfg.hd)
    assert cache.index.tolist() == [n0] * cfg.num_layers
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
    np.testing.assert_allclose(lg[:, -1].numpy(), full[:, n0 - 1].numpy(), atol=1e-3)
    _close_scaled(lg, jlg, 1e-5)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(n0, s):
        with torch.no_grad():
            lg, cache = model.decode_step(params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                                          cache)
        jlg, jcache = jstep(jparams, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=1e-3)
        _close_scaled(lg, jlg, 1e-5)
    assert cache.index.tolist() == [s] * cfg.num_layers


def test_serve_step_picks_the_greedy_token():
    _, _, params = _reference("h2o_gqa")
    _, cfg = _configs("h2o_gqa")
    model = build_model(cfg)
    toks = torch.from_numpy(_tokens(2, 20, 7))
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": toks}, max_len=24)
        nxt, logits, cache = make_serve_step(model)(params, {"tokens": toks[:, -1:]}, cache)
    assert torch.equal(nxt, logits[:, -1].argmax(-1)) and cache.index.tolist() == [21, 21]


def test_init_cache_matches_reference_layout():
    jmodel, _, _ = _reference("h2o_gqa")
    _, cfg = _configs("h2o_gqa")
    cache = build_model(cfg).init_cache(3, 200, device="cpu")
    jcache = jmodel.init_cache(3, 200)
    assert tuple(cache.k.shape) == jcache.k.shape and cache.index.shape == jcache.index.shape
    assert cache.k.dtype == torch.float32 and cache.slots == 64
