"""repro_torch.nn against repro.nn on the same numpy inputs (CPU).

Tolerances: f32 results that both packages compute in the same order of
operations are held at 1e-6 absolute for O(1) values (an ulp or two);
attention, whose sums run in other orders, at 1e-5 (as
``test_nn_components.py`` holds the reference's own ring-cache decode).
bf16 results at one bf16 ulp of the largest value (2**-8 relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as j_attn
from repro.nn.layers import rms_norm as j_rms_norm
from repro.nn.mlp import swiglu as j_swiglu
from repro.nn.rope import apply_rope as j_apply_rope
from repro_torch.nn import attention as attn
from repro_torch.nn.layers import dense_init, embed_init, embed_lookup, rms_norm, round_up
from repro_torch.nn.mlp import swiglu
from repro_torch.nn.rope import apply_rope


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x, g = _normal((2, 5, 48), 0, 3.0), _normal((48,), 1) + 1.0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    got = rms_norm(_t(x, tdt), _t(g, tdt))
    want = np.asarray(j_rms_norm(_j(x, jdt), _j(g, jdt)), np.float32)
    assert got.dtype == tdt
    atol = 1e-6 * np.abs(want).max() if dtype == "float32" else 2**-8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("offset", [0, 4093])
def test_rope_matches_reference(hd, offset):
    """Split-halves rotation at head_dim 120 (half 60) and 64, from
    position 0 (prefill) and deep in a sequence (decode)."""
    x = _normal((2, 7, 3, hd), 2)
    pos = np.arange(offset, offset + 7)
    got = apply_rope(_t(x), torch.from_numpy(pos))
    want = np.asarray(j_apply_rope(_j(x), jnp.asarray(pos)))
    # The inverse frequencies theta**(-i/half) come from each library's f32
    # pow, which may differ by an ulp (2**-23 relative); an angle pos * freq
    # then moves by up to pos * 2**-23 rad, and the rotated value by that
    # times |x|.
    atol = 1e-6 + (offset + 7) * 2.0**-23 * np.abs(x).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_rope_single_decode_position_broadcasts():
    x = _normal((2, 1, 4, 120), 3)
    got = apply_rope(_t(x), torch.tensor([77], dtype=torch.int32))
    want = np.asarray(j_apply_rope(_j(x), jnp.asarray([77], jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_swiglu_matches_reference():
    x, wg, wu, wd = _normal((2, 5, 32), 4), _normal((32, 64), 5, 0.2), \
        _normal((32, 64), 6, 0.2), _normal((64, 32), 7, 0.1)
    got = swiglu(_t(x), _t(wg), _t(wu), _t(wd))
    want = np.asarray(j_swiglu(_j(x), _j(wg), _j(wu), _j(wd)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_repeat_kv_interleaves_like_reference():
    """kv = 2 of 4 heads: query head h reads KV head h // 2 (an interleave,
    not a tile, which would give 0, 1, 0, 1)."""
    kv = np.arange(2 * 3 * 2 * 5, dtype=np.float32).reshape(2, 3, 2, 5)
    got = attn.repeat_kv(_t(kv), 4)
    want = np.asarray(j_attn.repeat_kv(_j(kv), 4))
    assert np.array_equal(got.numpy(), want)
    for h in range(4):
        assert np.array_equal(got[:, :, h].numpy(), kv[:, :, h // 2])
    assert np.array_equal(attn.repeat_kv(_t(kv), 2).numpy(), kv)


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("sk,chunk", [(64, 16), (50, 16), (37, 64)])
def test_chunked_causal_attention_matches_reference(sk, chunk, window):
    q, k, v = (_normal((2, sk, 4, 24), s) for s in (8, 9, 10))
    got = attn.chunked_causal_attention(_t(q), _t(k), _t(v), chunk_size=chunk, window=window)
    want = j_attn.chunked_causal_attention(_j(q), _j(k), _j(v), chunk_size=chunk, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_chunked_attention_with_query_offset_matches_reference():
    q, k, v = _normal((1, 5, 2, 16), 11), _normal((1, 30, 2, 16), 12), _normal((1, 30, 2, 16), 13)
    got = attn.chunked_causal_attention(_t(q), _t(k), _t(v), chunk_size=8, q_offset=25, window=9)
    want = j_attn.chunked_causal_attention(_j(q), _j(k), _j(v), chunk_size=8, q_offset=25,
                                           window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("steps", [3, 4, 10, 13])
def test_ring_cache_swa_decode_matches_reference(steps):
    """``test_nn_components.py:57`` in both packages: a window-4 ring cache
    after ``steps`` tokens (fewer than, exactly and past the slots, and
    wrapped more than once); the port's decode equals ``repro``'s and the
    dense attention over the last ``window`` keys."""
    b, h, kvh, hd, window = 1, 4, 2, 8, 4
    keys = _normal((steps, b, 1, kvh, hd), 14)
    vals = _normal((steps, b, 1, kvh, hd), 15)
    cache = attn.init_kv_cache(b, window, kvh, hd, torch.float32)
    jcache = j_attn.init_kv_cache(b, window, kvh, hd, jnp.float32)
    for t in range(steps):
        cache = attn.cache_update(cache, _t(keys[t]), _t(vals[t]))
        jcache = j_attn.cache_update(jcache, _j(keys[t]), _j(vals[t]))
    assert int(cache.index) == steps
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    q = _normal((b, 1, h, hd), 16)
    got = attn.decode_attention(_t(q), cache, num_heads=h, window=window)
    want = np.asarray(j_attn.decode_attention(_j(q), jcache, num_heads=h, window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    lo = max(0, steps - window)
    kr = attn.repeat_kv(_t(np.concatenate(keys[lo:], axis=1)), h)
    vr = attn.repeat_kv(_t(np.concatenate(vals[lo:], axis=1)), h)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", _t(q) / hd**0.5, kr), -1)
    dense = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)


def test_full_attention_decode_matches_reference():
    """A full-attention cache larger than the tokens written: unwritten
    slots are masked in both."""
    b, h, hd = 2, 2, 8
    cache = attn.init_kv_cache(b, 10, h, hd, torch.float32)
    jcache = j_attn.init_kv_cache(b, 10, h, hd, jnp.float32)
    for t in range(6):
        kv = _normal((b, 1, h, hd), 20 + t)
        cache = attn.cache_update(cache, _t(kv), _t(-kv))
        jcache = j_attn.cache_update(jcache, _j(kv), _j(-kv))
    q = _normal((b, 1, h, hd), 30)
    got = attn.decode_attention(_t(q), cache, num_heads=h)
    want = np.asarray(j_attn.decode_attention(_j(q), jcache, num_heads=h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cache_update_writes_in_place():
    cache = attn.init_kv_cache(1, 3, 1, 2, torch.float32)
    new = attn.cache_update(cache, torch.ones(1, 1, 1, 2), torch.ones(1, 1, 1, 2))
    assert new.k.data_ptr() == cache.k.data_ptr() and int(new.index) == 1
    assert cache.k[0, 0].sum() == 2 and cache.index.dtype == torch.int32


def test_init_helpers_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = dense_init(gen, (3, 400, 300), torch.bfloat16)
    assert w.shape == (3, 400, 300) and w.dtype == torch.bfloat16
    assert abs(w.float().std().item() * 400**0.5 - 1.0) < 0.02       # 1/sqrt(fan_in)
    assert abs(w.float().mean().item()) < 0.01 / 400**0.5 * 10
    e = embed_init(gen, 500, 64, torch.float32)
    assert abs(e.std().item() / 0.02 - 1.0) < 0.02
    assert torch.equal(dense_init(torch.Generator().manual_seed(5), (4, 4), torch.float32),
                       dense_init(torch.Generator().manual_seed(5), (4, 4), torch.float32))
    assert dense_init(gen, (2, 2), torch.float32, scale=0.0).abs().sum() == 0


def test_embed_lookup_and_round_up():
    table = _t(_normal((10, 4), 40))
    ids = torch.tensor([[3, 0], [9, 3]], dtype=torch.int32)
    got = embed_lookup(table, ids)
    want = np.asarray(jnp.take(_j(table.numpy()), jnp.asarray(ids.numpy()), axis=0))
    assert np.array_equal(got.numpy(), want)
    assert round_up(32000, 256) == 32000 and round_up(50304, 256) == 50432


def test_decode_attention_bf16_matches_reference():
    b, h, hd, window = 2, 4, 16, 5
    cache = attn.init_kv_cache(b, window, 2, hd, torch.bfloat16)
    jcache = j_attn.init_kv_cache(b, window, 2, hd, jnp.bfloat16)
    for t in range(7):
        kv = _normal((b, 1, 2, hd), 50 + t)
        cache = attn.cache_update(cache, _t(kv, torch.bfloat16), _t(-kv, torch.bfloat16))
        jcache = j_attn.cache_update(jcache, _j(kv, jnp.bfloat16), _j(-kv, jnp.bfloat16))
    q = _normal((b, 1, h, hd), 60)
    got = attn.decode_attention(_t(q, torch.bfloat16), cache, num_heads=h, window=window)
    want = np.asarray(j_attn.decode_attention(_j(q, jnp.bfloat16), jcache, num_heads=h,
                                              window=window), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2**-8 * np.abs(want).max())
    assert jax.default_backend() == "cpu"
