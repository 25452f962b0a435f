"""The port's MoE, VLM and audio transformers against ``repro``'s on the CPU.

``repro``'s seeded weights are carried across with
``convert.transformer_params_from_numpy`` (the two packages draw different
random numbers), the same numpy batch goes through both, and the port's
forward, loss, prefill and decode are held against ``repro``'s, as
``tests/test_torch_transformer.py`` holds the dense one
(``tests/test_torch_launch.py`` holds the serving launcher).

Configs, each ``reduced()`` (2 layers, d_model 256, f32 unless a test
says bf16): Mixtral-8x22B (MoE, 4 experts top-2, sliding window 64),
Phi-3.5-MoE (MoE, full attention), InternVL2-1B (8 patches of 64 in front
of the tokens) and MusicGen-medium (a grid of 4 codebooks).

Tolerances, ``test_torch_transformer.py``'s: f32 logits within 1e-5 x
max|logits|; bf16 logits within 3e-2 x max|logits|; the f32 loss within
1e-5 relative and the router aux loss within 1e-6; prefill and decode
against the full forward ``test_arch_smoke.py``'s 1e-3, with
``capacity_factor=8.0`` for MoE (the reference's no-drop setting there:
the forward's capacity comes from the whole sequence and decode's from
one token, so they disagree wherever the forward dropped an assignment).
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
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import (
    transformer_param_shapes,
    transformer_params_from_numpy,
    transformer_params_to_numpy,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models.steps import IGNORE, make_loss_fn, make_serve_step

CASES = {
    "mixtral": "mixtral_8x22b",
    "phi": "phi35_moe_42b",
    "internvl": "internvl2_1b",
    "musicgen": "musicgen_medium",
}
S = 128     # positions scored: a VLM's 8 patches and 120 tokens


def _configs(case, **over):
    arch = CASES[case]
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


def _batch(cfg, b=2, s=S, seed=0):
    """``test_arch_smoke.py``'s batch, as numpy: tokens and labels (a
    codebook grid for audio; s - num_patches text positions for a VLM,
    behind num_patches random patch embeddings)."""
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


def _jax(batch):
    return {k: jnp.asarray(a, jnp.float32 if a.dtype.kind == "f" else jnp.int32)
            for k, a in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(a) for k, a in batch.items()}


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel * float(np.abs(want).max()))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


# ------------------------------------------------------------------ build


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_builds_every_config(arch):
    """Every config builds, full and reduced; a transformer's parameter
    tree holds ``param_count()`` weights plus the final norm (and a VLM's
    patch projector, which the reference's count leaves out)."""
    cfg = get_config(arch)
    for c in (cfg, cfg.reduced()):
        assert build_model(c).cfg is c
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        n = sum(int(np.prod(shape)) for _, shape in _leaves(transformer_param_shapes(cfg)))
        extra = cfg.d_model + (cfg.patch_dim * cfg.d_model if cfg.family == "vlm" else 0)
        assert n == cfg.param_count() + extra


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), family="diffusion")
    with pytest.raises(ValueError, match="unknown family 'diffusion'"):
        build_model(cfg)


# ---------------------------------------------------------------- convert


@pytest.mark.parametrize("case", list(CASES))
def test_param_shapes_match_init_and_reference(case):
    _, jparams, _ = _reference(case)
    _, cfg = _configs(case)
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    shapes = transformer_param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes
    assert jax.tree.map(lambda a: tuple(a.shape), jparams) == shapes
    bf16 = build_model(dataclasses.replace(cfg, dtype="bfloat16")).init(
        torch.Generator().manual_seed(0))
    for path, t in _leaves(bf16):
        want = torch.float32 if path[-1] == "router" else torch.bfloat16
        assert t.dtype == want, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_params_round_trip_through_numpy(case, dtype):
    """repro's tree -> the port -> numpy -> the port, bit for bit; in a
    bf16 tree the MoE router stays f32, as repro keeps it."""
    _, jparams, params = _reference(case, dtype)
    tree = jax.tree.map(np.asarray, jparams)
    back = transformer_params_to_numpy(params)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == np.float32 and np.array_equal(got, w)
    _, cfg = _configs(case, dtype=dtype)
    again = transformer_params_from_numpy(back, cfg, device="cpu")
    for (path, a), (_, b) in zip(_leaves(again), _leaves(params)):
        assert torch.equal(a, b)
        jdt = functools.reduce(lambda t, k: t[k], path, jparams).dtype
        assert a.dtype == (torch.float32 if jdt == jnp.float32 else torch.bfloat16), path


def test_convert_refuses_a_tree_of_another_config():
    _, jparams, _ = _reference("phi")
    tree = jax.tree.map(np.asarray, jparams)
    _, mixtral = _configs("mixtral")      # the same reduced shapes ...
    transformer_params_from_numpy(tree, mixtral, device="cpu")
    _, fewer = _configs("phi", num_experts=2)   # ... but not 2 experts
    with pytest.raises(ValueError, match=r"\['layers'\]\['ffn'\]\['router'\]: expected shape"):
        transformer_params_from_numpy(tree, fewer, device="cpu")
    _, vlm = _configs("internvl")
    with pytest.raises(ValueError, match="expected keys"):
        transformer_params_from_numpy(tree, vlm, device="cpu")
    _, audio = _configs("musicgen", num_experts=4)   # the same layers, other embeddings
    with pytest.raises(ValueError, match=r"\['embed'\]: expected shape"):
        transformer_params_from_numpy(tree, audio, device="cpu")


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_reference(case, kernels):
    """Logits, the router aux loss and the loss (with a VLM's prefix
    ignored and an MoE's aux term) against repro's, with the kernels on
    and off (repro runs its Pallas kernel in interpret mode at S = 128;
    the port's CPU tensors take the plain version)."""
    jmodel, jparams, params = _reference(case)
    jcfg, cfg = _configs(case, use_pallas_kernels=kernels)
    model = build_model(cfg)
    jmodel = j_build_model(jcfg)
    batch = _batch(cfg, seed=1)
    want, jaux = jax.jit(jmodel.forward)(jparams, _jax(batch))
    before = fa.launch_count()
    with torch.no_grad():
        got, aux = model.forward(params, _torch(batch))
        loss = make_loss_fn(model)(params, _torch(batch))
    assert fa.launch_count() == before          # the CPU takes the plain version
    if cfg.family == "audio":
        assert got.shape == (2, S, cfg.num_codebooks, cfg.padded_vocab)
    else:
        assert got.shape == (2, S, cfg.padded_vocab)
    _close_scaled(got, want, 1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert (float(aux) > 0) == bool(cfg.num_experts)
    jloss = float(jax.jit(j_make_loss_fn(jmodel))(jparams, _jax(batch)))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)


def test_loss_terms():
    """The VLM loss scores only the text positions; the MoE loss adds
    0.01 x the mean router aux loss."""
    from repro_torch.models.steps import cross_entropy

    _, _, params = _reference("internvl")
    _, cfg = _configs("internvl")
    model = build_model(cfg)
    batch = _torch(_batch(cfg, seed=2))
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
        loss = make_loss_fn(model)(params, batch)
    text = cross_entropy(logits[:, cfg.num_patches:], batch["labels"])
    assert abs(float(loss) - float(text)) <= 1e-6 * float(text)
    padded = torch.cat([torch.full((2, cfg.num_patches), IGNORE), batch["labels"]], dim=1)
    assert torch.equal(loss, cross_entropy(logits, padded))

    _, _, params = _reference("phi")
    _, cfg = _configs("phi")
    model = build_model(cfg)
    batch = _torch(_batch(cfg, seed=2))
    with torch.no_grad():
        logits, aux = model.forward(params, batch)
        loss = make_loss_fn(model)(params, batch)
    assert torch.equal(loss, cross_entropy(logits, batch["labels"]) + 0.01 * aux)


def _zero_router(params, zeros_like):
    ffn = dict(params["layers"]["ffn"], router=zeros_like(params["layers"]["ffn"]["router"]))
    return dict(params, layers=dict(params["layers"], ffn=ffn))


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_matches_reference(case):
    """bf16 logits against repro's.  An MoE's routing is decided in f32
    from a bf16 hidden state that the two frameworks round at different
    places, so with its seeded router a few near-tied choices flip between
    the packages (and shift the capacity slots of later tokens), which
    moves those tokens' logits by O(1).  The MoE cases therefore zero the
    router in both: every expert ties, the lower-index rule sends each
    token to experts 0 and 1 in both packages, and the same assignments
    drop, so the bf16 expert products, the combine and the drops are held
    to the dense bar.  The f32 tests hold the seeded routing exactly."""
    jmodel, jparams, params = _reference(case, "bfloat16")
    jcfg, cfg = _configs(case, dtype="bfloat16", use_pallas_kernels=True)
    if cfg.num_experts:
        jparams = _zero_router(jparams, jnp.zeros_like)
        params = _zero_router(params, torch.zeros_like)
    batch = _batch(cfg, seed=3)
    batch.pop("labels")
    want, jaux = jax.jit(j_build_model(jcfg).forward)(jparams, _jax(batch))
    with torch.no_grad():
        got, aux = build_model(cfg).forward(params, _torch(batch))
    assert got.dtype == torch.bfloat16
    _close_scaled(got, want, 3e-2)
    assert float(aux) == float(jaux)


# ---------------------------------------------------------- prefill/decode


@pytest.mark.parametrize("case,s,n0", [("mixtral", 96, 80), ("phi", 48, 44),
                                       ("internvl", 48, 40), ("musicgen", 48, 44)])
def test_prefill_and_decode_match_reference_and_forward(case, s, n0):
    """``test_arch_smoke.py``'s decode check in both packages, at
    ``capacity_factor=8.0`` for MoE.  Mixtral's 80-token prompt exceeds the
    window of 64 (the ring wraps); a VLM's cache holds its patches, so the
    forward's positions are offset by num_patches."""
    _, jparams, params = _reference(case)
    jcfg, cfg = _configs(case)
    if cfg.num_experts:
        jcfg, cfg = _configs(case, capacity_factor=8.0)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    batch = _batch(cfg, s=s + cfg.num_patches, seed=6)
    batch.pop("labels")
    toks = batch["tokens"]
    off = cfg.num_patches
    max_len = s + off
    pre = dict(batch, tokens=toks[:, :n0])
    with torch.no_grad():
        full, aux = model.forward(params, _torch(batch))
        lg, cache = model.prefill(params, _torch(pre), max_len=max_len)
    assert float(aux) > 0 or not cfg.num_experts
    jlg, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=max_len))(jparams, _jax(pre))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), atol=1e-5)
    np.testing.assert_allclose(_np32(lg[:, -1]), _np32(full[:, off + n0 - 1]), atol=1e-3)
    _close_scaled(lg, jlg, 1e-5)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(n0, s):
        step = {"tokens": toks[:, t:t + 1]}
        with torch.no_grad():
            lg, cache = model.decode_step(params, _torch(step), cache)
        jlg, jcache = jstep(jparams, _jax(step), jcache)
        np.testing.assert_allclose(_np32(lg[:, 0]), _np32(full[:, off + t]), atol=1e-3)
        _close_scaled(lg, jlg, 1e-5)
    assert cache.index.tolist() == [off + s] * cfg.num_layers


def test_audio_serve_step_picks_one_token_per_codebook():
    _, _, params = _reference("musicgen")
    _, cfg = _configs("musicgen")
    model = build_model(cfg)
    toks = torch.from_numpy(_batch(cfg, s=20, seed=7)["tokens"])
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, max_len=24)
        nxt, logits, cache = make_serve_step(model)(params, {"tokens": toks[:, -1:]}, cache)
    assert nxt.shape == (2, cfg.num_codebooks) and logits.shape == (2, 1, 4, cfg.padded_vocab)
    assert torch.equal(nxt, logits[:, -1].argmax(-1)) and cache.index.tolist() == [21, 21]
