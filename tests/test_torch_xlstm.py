"""The port's xLSTM cells, layers and model against ``repro``'s on the CPU.

``repro``'s seeded weights are carried across with
``convert.xlstm_params_from_numpy`` (the two packages draw different
random numbers), the same numpy inputs go through both, and the port's
sLSTM cell and scan, mLSTM and sLSTM layers, forward (kernel route and
plain route), loss, prefill and decode are held against ``repro``'s.

Config: xLSTM-350M reduced to 12 layers, so two periods of five mLSTM
layers and one sLSTM layer; d_model 256, 4 heads of 64, chunk 16, f32.
``repro``'s kernel route runs its Pallas ``mlstm_scan`` in interpret mode.

Tolerances.  A single layer agrees with ``repro``'s within 1e-5 of its
output on the same input.  This random-weight model amplifies rounding:
one-ulp noise on its embeddings moves its f32 logits by 2.5e-4 x
max|logits| (``test_reduced_model_amplifies_rounding``), and the
frameworks' own roundings land at 2.7e-4.  So whole-model f32 results
(logits, the loss, the caches) are held within 2e-3 x max|want|, about
eight times the model's response to one ulp.  In bf16 amplified roundings
reach O(1) in the logits, so the bf16 forward is held by its loss, within
1e-2 relative.  The port's routes and steps against each other: the
kernel route against the plain one, 1e-5 x max|logits| (on the CPU both
are the same plain scan, at chunks that differ only where S is ragged),
and prefill and decode against the full forward, ``test_arch_smoke.py``'s
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
from repro.models import blocks as j_blocks
from repro.models import build_model as j_build_model
from repro.models.steps import make_loss_fn as j_make_loss_fn
from repro.nn import xlstm as j_xlstm
from repro_torch.configs import get_config
from repro_torch.convert import (
    xlstm_param_shapes,
    xlstm_params_from_numpy,
    xlstm_params_to_numpy,
)
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.models import blocks, build_model
from repro_torch.models.steps import make_loss_fn
from repro_torch.models.xlstm_model import XLSTMModel
from repro_torch.nn import xlstm

LAYERS = 12
WHOLE = 2e-3     # whole-model f32 results against repro's (see above)
F32_LEAVES = {("mlstm", "wi"), ("mlstm", "wf"), ("slstm", "rw")}


def _configs(**over):
    return (dataclasses.replace(j_get_config("xlstm_350m").reduced(layers=LAYERS), **over),
            dataclasses.replace(get_config("xlstm_350m").reduced(layers=LAYERS), **over))


@functools.cache
def _reference(dtype="float32"):
    """repro's model, its params and the port's copy of them."""
    jcfg, cfg = _configs(dtype=dtype)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, xlstm_params_from_numpy(tree, cfg, device="cpu")


def _tokens(b, s, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _np32(got), _np32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


def _hidden(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _states(b, d, seed):
    """A nonzero sLSTM state: c, n > 0 as the recurrence keeps them, m ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((b, d)).astype(np.float32)
    n = (np.abs(rng.standard_normal((b, d))) + 0.5).astype(np.float32)
    h = rng.standard_normal((b, d)).astype(np.float32)
    m = rng.standard_normal((b, d)).astype(np.float32)
    return c, n, h, m


# ---------------------------------------------------------------- sLSTM cell


@pytest.mark.parametrize("zero", [True, False])
def test_slstm_cell_and_scan_match_reference(zero):
    b, s, heads, d = 2, 37, 4, 64
    rng = np.random.default_rng(3)
    x_gates = rng.standard_normal((b, s, 4 * d)).astype(np.float32)
    r_w = (rng.standard_normal((4, heads, d // heads, d // heads)) / 4).astype(np.float32)
    st = ([np.zeros((b, d), np.float32)] * 3 + [np.full((b, d), -1e30, np.float32)]
          if zero else _states(b, d, 4))
    jst = j_xlstm.SLSTMState(*(jnp.asarray(a) for a in st))
    tst = xlstm.SLSTMState(*(torch.from_numpy(a) for a in st))
    got = xlstm._slstm_cell(torch.from_numpy(x_gates[:, 0]), torch.from_numpy(r_w), tst, heads)
    want = j_xlstm._slstm_cell(jnp.asarray(x_gates[:, 0]), jnp.asarray(r_w), jst, heads)
    for g, w in zip(got, want):
        _close_scaled(g, w, 1e-5)
    hs, fin = xlstm.slstm_scan(torch.from_numpy(x_gates), torch.from_numpy(r_w), tst, heads)
    jhs, jfin = j_xlstm.slstm_scan(jnp.asarray(x_gates), jnp.asarray(r_w), jst, heads)
    assert hs.shape == (b, s, d) and hs.dtype == torch.float32
    _close_scaled(hs, jhs, 1e-5)
    for g, w in zip(fin, jfin):
        _close_scaled(g, w, 1e-5)
    # The scan is the cell applied step by step.
    state = tst
    for t in range(3):
        state = xlstm._slstm_cell(torch.from_numpy(x_gates[:, t]), torch.from_numpy(r_w),
                                  state, heads)
        np.testing.assert_allclose(state.h.numpy(), hs[:, t].numpy(), rtol=1e-6, atol=1e-6)


def test_slstm_scan_keeps_bf16_gates_dtype():
    b, s, heads, d = 1, 5, 2, 16
    rng = np.random.default_rng(5)
    x_gates = torch.from_numpy(rng.standard_normal((b, s, 4 * d)).astype(np.float32))
    r_w = torch.from_numpy((rng.standard_normal((4, heads, 8, 8)) / 3).astype(np.float32))
    st = xlstm.init_slstm_state(b, d)
    hs, fin = xlstm.slstm_scan(x_gates.to(torch.bfloat16), r_w, st, heads)
    want, _ = xlstm.slstm_scan(x_gates.to(torch.bfloat16).float(), r_w, st, heads)
    assert hs.dtype == torch.bfloat16 and fin.h.dtype == torch.float32
    assert torch.equal(hs, want.to(torch.bfloat16))


# ------------------------------------------------------------------ layers


def _layer_params(kind, jcfg, cfg):
    init = j_blocks.init_mlstm_layer if kind == "mlstm" else j_blocks.init_slstm_layer
    jp = init(jax.random.PRNGKey(3), jcfg)
    keep = {k for part, k in F32_LEAVES if part == kind}
    p = {k: torch.tensor(np.asarray(v, np.float32),
                         dtype=torch.float32 if k in keep else cfg.torch_dtype)
         for k, v in jp.items()}
    return jp, p


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("s", [64, 40, 7])
def test_mlstm_layer_forward_matches_reference(s, kernels):
    """State None: the scoring forward's layer.  S = 40 and 7 pad the scan
    to whole chunks (of 16; ``repro`` runs S = 7 as one chunk of 7)."""
    jcfg, cfg = _configs(use_pallas_kernels=kernels)
    jp, p = _layer_params("mlstm", jcfg, cfg)
    x = _hidden(2, s, cfg.d_model, s)
    want, want_state = j_blocks.apply_mlstm_layer(jp, jnp.asarray(x), jcfg, None)
    before = ms.launch_count()
    got, state = blocks.apply_mlstm_layer(p, torch.from_numpy(x), cfg, None)
    assert ms.launch_count() == before and state is None and want_state is None
    _close_scaled(got, want, 1e-5)


def test_mlstm_layer_prefill_and_decode_match_reference():
    """With a state: S > 1 (prefill, the plain chunked scan from the zero
    state) gives the final state; S = 1 steps it on."""
    jcfg, cfg = _configs()
    jp, p = _layer_params("mlstm", jcfg, cfg)
    h, hd = cfg.num_heads, cfg.hd
    x = _hidden(2, 45, cfg.d_model, 9)
    full, _ = blocks.apply_mlstm_layer(p, torch.from_numpy(x), cfg, None)
    got, st = blocks.apply_mlstm_layer(p, torch.from_numpy(x[:, :42]), cfg,
                                       xlstm.init_mlstm_state(2, h, hd, hd))
    want, jst = j_blocks.apply_mlstm_layer(jp, jnp.asarray(x[:, :42]), jcfg,
                                           j_xlstm.init_mlstm_state(2, h, hd, hd))
    _close_scaled(got, want, 1e-5)
    for g, w in zip(st, jst):
        _close_scaled(g, w, 2e-5)
    for t in range(42, 45):
        got, st = blocks.apply_mlstm_layer(p, torch.from_numpy(x[:, t:t + 1]), cfg, st)
        want, jst = j_blocks.apply_mlstm_layer(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jst)
        _close_scaled(got, want, 1e-5)
        for g, w in zip(st, jst):
            _close_scaled(g, w, 2e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(), atol=1e-4)


@pytest.mark.parametrize("stateful", [False, True])
def test_slstm_layer_matches_reference(stateful):
    jcfg, cfg = _configs()
    jp, p = _layer_params("slstm", jcfg, cfg)
    d = cfg.d_model
    x = _hidden(2, 30, d, 12)
    st = _states(2, d, 13) if stateful else None
    want, jst = j_blocks.apply_slstm_layer(
        jp, jnp.asarray(x), jcfg,
        None if st is None else j_xlstm.SLSTMState(*(jnp.asarray(a) for a in st)))
    got, tst = blocks.apply_slstm_layer(
        p, torch.from_numpy(x), cfg,
        None if st is None else xlstm.SLSTMState(*(torch.from_numpy(a) for a in st)))
    _close_scaled(got, want, 1e-5)
    if stateful:
        for g, w in zip(tst, jst):
            _close_scaled(g, w, 1e-5)
    else:
        assert tst is None and jst is None


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layers_bf16_match_reference_and_keep_f32_gates(kind):
    jcfg, cfg = _configs(dtype="bfloat16", use_pallas_kernels=True)
    jp, p = _layer_params(kind, jcfg, cfg)
    for name in ("wi", "wf", "rw"):
        if name in p:
            assert p[name].dtype == torch.float32
    assert p["out"].dtype == torch.bfloat16
    apply_j = j_blocks.apply_mlstm_layer if kind == "mlstm" else j_blocks.apply_slstm_layer
    apply_t = blocks.apply_mlstm_layer if kind == "mlstm" else blocks.apply_slstm_layer
    x = _hidden(2, 48, cfg.d_model, 11)
    want, _ = apply_j(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, None)
    got, _ = apply_t(p, torch.from_numpy(x).to(torch.bfloat16), cfg, None)
    assert got.dtype == torch.bfloat16
    _close_scaled(got, want, 3e-2)


# ------------------------------------------------------------ build, convert


def test_build_model_gives_xlstm_at_full_and_reduced_width():
    full = build_model(get_config("xlstm_350m"))
    assert isinstance(full, XLSTMModel)
    assert (full.num_periods, full.mlstm_per_period, full.has_slstm) == (4, 5, True)
    shapes = xlstm_param_shapes(full.cfg)
    count = sum(int(np.prod(s)) for s in jax.tree.leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert count == 212_550_656
    assert shapes["mlstm"]["wq"] == (4, 5, 1024, 1024) and shapes["slstm"]["rw"] == (4, 4, 4,
                                                                                      256, 256)
    _, cfg = _configs()
    small = build_model(cfg)
    assert (small.num_periods, small.mlstm_per_period) == (2, 5)
    with pytest.raises(ValueError, match="slstm_period"):
        XLSTMModel(dataclasses.replace(cfg, num_layers=10))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_shapes_and_dtypes_match_init_and_reference(dtype):
    jcfg, cfg = _configs(dtype=dtype)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    shapes = xlstm_param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == shapes
    jdt = jax.tree.map(lambda a: "float32" if a.dtype == jnp.float32 else "bfloat16", jparams)
    tdt = jax.tree.map(lambda a: "float32" if a.dtype == torch.float32 else "bfloat16", port)
    assert tdt == jdt
    for part, name in F32_LEAVES:
        assert port[part][name].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_through_numpy(dtype):
    """Including wi, wf and rw, which stay f32 under a bf16 config."""
    _, jparams, params = _reference(dtype)
    _, cfg = _configs(dtype=dtype)
    back = xlstm_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.tree.map(np.asarray, jparams))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == np.float32 and np.array_equal(got, w)
    again = xlstm_params_from_numpy(back, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(params)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(again):
        keys = tuple(k.key for k in path)
        assert leaf.dtype == (torch.float32 if keys in F32_LEAVES else cfg.torch_dtype), keys
    forced = xlstm_params_from_numpy(back, cfg, device="cpu", dtype=torch.bfloat16)
    assert forced["slstm"]["rw"].dtype == torch.float32
    assert forced["mlstm"]["wq"].dtype == torch.bfloat16


def test_convert_refuses_a_tree_of_another_config():
    _, jparams, _ = _reference()
    tree = jax.tree.map(np.asarray, jparams)
    _, other = _configs(num_heads=2, head_dim=128)
    with pytest.raises(ValueError, match=r"\['mlstm'\]\['wi'\]: expected shape"):
        xlstm_params_from_numpy(tree, other, device="cpu")
    _, cfg = _configs()
    with pytest.raises(ValueError, match="expected keys"):
        xlstm_params_from_numpy(dict(tree, extra=tree["ln_f"]), cfg, device="cpu")


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("s", [128, 100])
def test_forward_and_loss_match_reference(s, kernels):
    """Both packages through their kernel route and their plain route; at
    S = 100 every mLSTM layer pads its scan to whole chunks."""
    _, jparams, params = _reference()
    jcfg, cfg = _configs(use_pallas_kernels=kernels)
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    toks, labels = _tokens(2, s, 1), _tokens(2, s, 2)
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    want, _ = jax.jit(jmodel.forward)(jparams, jbatch)
    before = ms.launch_count()
    with torch.no_grad():
        got, aux = model.forward(params, batch)
        loss = make_loss_fn(model)(params, batch)
    assert ms.launch_count() == before       # the CPU takes the plain version
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
    2.5e-4), while a single layer stays within 1e-5."""
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
    """bf16 rounds at 2**-8, which this model amplifies; the loss, an
    average over all positions, stays within 1e-2 relative."""
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


def _close_cache(cache, jcache):
    for got, want in zip((*cache.mlstm, *cache.slstm), (*jcache.mlstm, *jcache.slstm)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        _close_scaled(got, want, WHOLE)


@pytest.mark.parametrize("s,n0", [(48, 44), (73, 70), (20, 1)])
def test_prefill_and_decode_match_reference_and_forward(s, n0):
    """Prefill n0 tokens, then decode to s, against ``repro``'s prefill and
    decode steps and against the port's forward over all s tokens; a
    one-token prompt takes the decode recurrences from the zero state."""
    jmodel, jparams, params = _reference()
    _, cfg = _configs()
    model = build_model(cfg)
    toks = _tokens(2, s, 6)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :n0])}, max_len=s)
    jlg, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=s))(
        jparams, {"tokens": jnp.asarray(toks[:, :n0])})
    assert cache.mlstm.c.shape == (2, 5, 2, cfg.num_heads, cfg.hd, cfg.hd)
    assert cache.slstm.h.shape == (2, 2, cfg.d_model)
    _close_cache(cache, jcache)
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
        _close_cache(cache, jcache)


def test_init_cache_matches_reference_layout():
    jmodel, _, _ = _reference()
    _, cfg = _configs()
    cache = build_model(cfg).init_cache(3, 200, device="cpu")
    jcache = jmodel.init_cache(3, 200)
    for got, want in zip((*cache.mlstm, *cache.slstm), (*jcache.mlstm, *jcache.slstm)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
