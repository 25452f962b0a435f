"""repro_torch.prng against the installed jax.random (threefry2x32,
``jax_threefry_partitionable=True``), on the CPU.

- Keys, ``split``, ``fold_in``, ``random_bits``, ``uniform`` and
  ``bernoulli`` equal jax's bit for bit, from numpy keys (the host path)
  and from int64 tensor keys (the device path, here on the CPU).
- ``normal`` is XLA's f32 ``erf_inv`` polynomial on jax's uniforms; jax's
  own ``log1p`` rounds some words differently, so the normals are held to
  NORMAL_ULPS (measured at most 3, in about 1% of the words).
- A batch of keys gives, key by key, what one call per key gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.testing import given, settings, st
from repro_torch import prng

SEEDS = [0, 1, 2**31 - 1, 2**31, 2**32 + 5]
SHAPES = [(), (1,), (7,), (3, 5), (4, 10, 41)]
NORMAL_ULPS = 4


def _tensor(key):
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + [-1, -(2**40)])
def test_prng_key_equals_jax(seed):
    """With x64 off, as the reference runs, jax takes the seed modulo
    2**32: the high word stays 0 for every seed."""
    want = np.asarray(jax.random.PRNGKey(seed))
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert np.array_equal(prng.key_data(got), np.asarray(jax.random.key_data(want)))
    assert np.array_equal(prng.key_data(_tensor(got)), want)


def test_prng_key_refuses_what_jax_refuses():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2**64 - 1)
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**64 - 1)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        prng.split(np.zeros(3, np.uint32))


@pytest.mark.parametrize("num", [1, 2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    key = prng.PRNGKey(seed)
    assert np.array_equal(prng.split(key, num), want)
    assert np.array_equal(prng.split(_tensor(key), num).numpy(), want.astype(np.int64))


def test_split_of_zero_key_is_the_documented_pair():
    assert prng.split(prng.PRNGKey(0)).tolist() == [[1797259609, 2579123966],
                                                    [928981903, 3453687069]]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_equals_jax(seed):
    jkey, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 7, 2**31 + 3):
        want = np.asarray(jax.random.fold_in(jkey, data))
        assert np.array_equal(prng.fold_in(key, data), want)
        assert np.array_equal(prng.fold_in(_tensor(key), data).numpy(), want)
    for m in (1, 4, 20):
        want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(m)))
        assert np.array_equal(prng.fold_in(key, np.arange(m)), want)
        assert np.array_equal(prng.fold_in(_tensor(key), torch.arange(m)).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_equal_jax(seed, shape):
    """Odd and even element counts alike: the partitionable layout hashes
    each element's row-major index as a 64-bit counter."""
    jkey, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    assert np.array_equal(prng.random_bits(key, shape), bits)
    assert np.array_equal(prng.random_bits(_tensor(key), shape).numpy(), bits.astype(np.int64))
    assert np.array_equal(prng.random_bits(key, shape, device="cpu").numpy(),
                          bits.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (0.0, 2.0 * np.pi), (-3.0, 0.5)):
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
        assert np.array_equal(prng.uniform(key, shape, minval=lo, maxval=hi), want)
        got = prng.uniform(key, shape, minval=lo, maxval=hi, device="cpu")
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    for p in (0.0, 0.3, 0.9, 1.0):
        want = np.asarray(jax.random.bernoulli(jkey, p, shape))
        assert np.array_equal(prng.bernoulli(key, p, shape), want)
        assert np.array_equal(prng.bernoulli(key, p, shape, device="cpu").numpy(), want)
    probs = np.random.default_rng(seed % 97).random(shape).astype(np.float32)
    want = np.asarray(jax.random.bernoulli(jkey, jnp.asarray(probs), shape))
    assert np.array_equal(prng.bernoulli(key, probs, shape), want)
    assert np.array_equal(prng.bernoulli(key, torch.from_numpy(probs), device="cpu").numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    key = prng.PRNGKey(seed)
    host = prng.normal(key, shape)
    assert host.dtype == np.float32 and host.shape == want.shape
    assert _ulps(host, want).max(initial=0) <= NORMAL_ULPS
    assert np.array_equal(prng.normal(key, shape, device="cpu").numpy(), host)


def test_normal_agrees_with_jax_on_most_words():
    """A large draw: the words jax's own log1p rounds differently are
    few, and none is off by more than NORMAL_ULPS."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (200_000,)))
    d = _ulps(prng.normal(prng.PRNGKey(5), (200_000,)), want)
    assert d.max() <= NORMAL_ULPS and (d > 0).mean() < 0.02


def test_normal_is_deterministic():
    """Every rounding step is an IEEE operation or a float64 result
    rounded once, so a draw repeats bit for bit (torch's f32 sqrt on the
    CPU alone does not)."""
    key = prng.split(prng.PRNGKey(0), 4)[0]
    first = prng.normal(key, (32, 1280))
    for _ in range(3):
        assert np.array_equal(prng.normal(key, (32, 1280)), first)


def test_batched_keys_equal_per_key_calls():
    """Worker-stacked keys, as the policies hold them: each row of a
    batched draw is the per-key draw (jax's vmap of the same calls)."""
    keys = prng.fold_in(prng.PRNGKey(3), np.arange(5))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(jnp.arange(5))
    probs = np.random.default_rng(0).random((5, 3, 4)).astype(np.float32)
    batched = {
        "split": prng.split(keys, 3),
        "bits": prng.random_bits(keys, (3, 4)),
        "uniform": prng.uniform(keys, (3, 4)),
        "normal": prng.normal(keys, (3, 4)),
        "bernoulli": prng.bernoulli(keys, probs, (3, 4)),
        "scalar": prng.bernoulli(prng.split(keys, 2), 0.7, ()),
    }
    assert batched["split"].shape == (5, 3, 2) and batched["scalar"].shape == (5, 2)
    for m in range(5):
        k = keys[m]
        assert np.array_equal(batched["split"][m], prng.split(k, 3))
        assert np.array_equal(batched["bits"][m], prng.random_bits(k, (3, 4)))
        assert np.array_equal(batched["uniform"][m], prng.uniform(k, (3, 4)))
        assert np.array_equal(batched["normal"][m], prng.normal(k, (3, 4)))
        assert np.array_equal(batched["bernoulli"][m], prng.bernoulli(k, probs[m], (3, 4)))
        assert np.array_equal(batched["scalar"][m],
                              [prng.bernoulli(s, 0.7, ()) for s in prng.split(k, 2)])
    want = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (3, 4)))(jkeys, jnp.asarray(probs))
    assert np.array_equal(batched["bernoulli"], np.asarray(want))
    on_tensor = prng.uniform(_tensor(keys), (3, 4))
    assert np.array_equal(on_tensor.numpy(), batched["uniform"])


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**32 - 1),
       rows=st.integers(min_value=1, max_value=9),
       cols=st.integers(min_value=1, max_value=33),
       fold=st.integers(min_value=0, max_value=2**32 - 1))
def test_draws_equal_jax_for_any_seed_and_shape(seed, rows, cols, fold):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    key = prng.fold_in(prng.PRNGKey(seed), fold)
    assert np.array_equal(key, np.asarray(jkey))
    shape = (rows, cols)
    assert np.array_equal(prng.random_bits(key, shape),
                          np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    assert np.array_equal(prng.uniform(key, shape), np.asarray(jax.random.uniform(jkey, shape)))
    assert np.array_equal(prng.bernoulli(key, 0.25, shape),
                          np.asarray(jax.random.bernoulli(jkey, 0.25, shape)))
    assert _ulps(prng.normal(key, shape), np.asarray(jax.random.normal(jkey, shape))).max() \
        <= NORMAL_ULPS
