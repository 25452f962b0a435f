"""Threefry-2x32 counter-based random numbers with ``jax.random``'s bits.

``repro`` draws its randomness with ``jax.random`` under the default
``threefry2x32`` implementation and ``jax_threefry_partitionable=True``
(the default in the jax the reference is tested with).  This module
computes the same 32-bit words, so a seed gives the port the reference's
keys, random bits, uniforms and Bernoulli draws bit for bit:

- :func:`PRNGKey`, :func:`key_data`,
  :func:`split`, :func:`fold_in`;
- :func:`random_bits`, :func:`uniform`, :func:`bernoulli` and
  :func:`normal`.  ``normal`` is ``sqrt(2) * erf_inv(u)`` of a uniform on
  ``(nextafter(-1, 0), 1)``, as ``jax.random.normal`` computes it, with
  XLA's f32 ``erf_inv`` polynomial: the uniforms are bit-equal, and the
  normals differ from jax's in about 1% of the words, by at most 2 f32
  ulps, where XLA's own ``log1p`` rounds differently.

Keys are the raw ``(..., 2)`` words ``(hi, lo)``.  Every function takes a
batch of keys of shape ``(..., 2)`` and computes, for each key, the words
one call with that key alone would give; a draw of shape ``S`` from keys
of batch shape ``B`` has shape ``B + S``.  So the reference's per-worker
``fold_in(PRNGKey(seed), axis_index)`` under ``vmap`` is
``fold_in(PRNGKey(seed), arange(M))`` here.

Where the words live follows the key.  A numpy key (``uint32``, what
:func:`PRNGKey` returns) is hashed on the host in numpy: keys that do not
depend on the data are built there, where a few dozen words cost
microseconds.  A torch key (``int64`` words) is hashed on its own device,
and a draw given ``device=`` moves its key there first: bulk bits are
drawn where they are used, in one batched pass.  The rounds run in int64
masked to 32 bits (torch has no ``uint32`` add or shift on the CPU), so
every device computes the same integers.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch._device import to_device

Key = Union[np.ndarray, torch.Tensor]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000                 # the f32 bit pattern of 1.0


def _hash(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key words ``(k0, k1)``: int64 arrays or tensors holding values in
    [0, 2**32), broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: Key, device=None):
    """The key's words as int64: numpy on the host, or a tensor on the
    key's device (or ``device``, when given)."""
    if device is not None:
        if not isinstance(key, torch.Tensor):
            return to_device(np.asarray(key).astype(np.int64), device)
        return key.to(device=device, dtype=torch.int64)
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64)
    return np.asarray(key).astype(np.int64)


def _check_key(words) -> None:
    if words.ndim < 1 or words.shape[-1] != 2:
        raise ValueError(
            f"a threefry key is (..., 2) uint32 words, got shape {tuple(words.shape)}"
        )


def _as_key(words):
    """int64 words -> a key: uint32 on the host, int64 tensors as they
    are."""
    if isinstance(words, torch.Tensor):
        return words
    return words.astype(np.uint32)


def _stack(a, b):
    if isinstance(a, torch.Tensor):
        return torch.stack([a, b], dim=-1)
    return np.stack([np.asarray(a), np.asarray(b)], axis=-1)


def _iota(words, count: int):
    if isinstance(words, torch.Tensor):
        return torch.arange(count, dtype=torch.int64, device=words.device)
    return np.arange(count, dtype=np.int64)


def _batched(words, ndim: int):
    """The two key words, shaped to broadcast against ``ndim`` trailing
    draw dims."""
    k0, k1 = words[..., 0], words[..., 1]
    shape = tuple(k0.shape) + (1,) * ndim
    return k0.reshape(shape), k1.reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as the reference runs it, with x64
    off: the seed is taken as a 32-bit integer (modulo 2**32, negatives
    wrapping), so the words are ``(0, seed mod 2**32)``; a seed outside
    the int64 range raises, as jax does."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    return np.array([0, seed & _MASK], dtype=np.uint32)


def key_data(keys: Key) -> np.ndarray:
    """The raw ``(..., 2)`` uint32 words of ``keys``, on the host."""
    if isinstance(keys, torch.Tensor):
        keys = keys.detach().cpu().numpy()
    words = np.asarray(keys).astype(np.int64)
    _check_key(words)
    return (words & _MASK).astype(np.uint32)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: a new key from ``key`` and a 32-bit
    integer.  ``data`` may be an array (a tensor for a tensor key); its
    shape broadcasts against the key's batch shape, so
    ``fold_in(PRNGKey(s), arange(M))`` is the M per-worker keys."""
    words = _words(key)
    _check_key(words)
    if isinstance(words, torch.Tensor):
        d = torch.as_tensor(data, device=words.device).to(torch.int64) & _MASK
    else:
        d = np.asarray(data).astype(np.int64) & _MASK
    x0, x1 = _hash(words[..., 0], words[..., 1], d * 0, d)
    return _as_key(_stack(x0, x1))


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split``: ``num`` new keys from each key, shape
    ``(..., num, 2)``; key ``i`` hashes the counter ``(0, i)``."""
    words = _words(key)
    _check_key(words)
    k0, k1 = _batched(words, 1)
    lo = _iota(words, int(num))
    x0, x1 = _hash(k0, k1, lo * 0, lo)
    return _as_key(_stack(x0, x1))


def _counter(words, shape: Sequence[int]):
    n = math.prod(shape)
    flat = _iota(words, n)
    return (flat >> 32).reshape(tuple(shape)), (flat & _MASK).reshape(tuple(shape))


def _bits(words, shape):
    _check_key(words)
    shape = tuple(int(s) for s in shape)
    k0, k1 = _batched(words, len(shape))
    hi, lo = _counter(words, shape)
    x0, x1 = _hash(k0, k1, hi, lo)
    return x0 ^ x1


def random_bits(key: Key, shape: Sequence[int] = (), *, device=None):
    """``jax.random.bits(key, shape, uint32)``: 32 random bits per element
    (uint32 numpy for a numpy key, int64 values in [0, 2**32) for a
    tensor key), each hashing its row-major index as a 64-bit counter."""
    words = _words(key, device)
    out = _bits(words, shape)
    return out if isinstance(out, torch.Tensor) else np.asarray(out).astype(np.uint32)


def uniform(
    key: Key,
    shape: Sequence[int] = (),
    dtype=torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
    *,
    device=None,
):
    """``jax.random.uniform`` in f32 (x64 off): the top 23 random bits as
    the mantissa of a float in [1, 2), minus 1, then scaled to
    ``[minval, maxval)`` by one fused multiply-add, as XLA computes it,
    and clamped below at ``minval``."""
    if dtype not in (torch.float32, np.float32, "float32"):
        raise ValueError(f"uniform draws float32 (jax's x64-off default), got {dtype}")
    words = _words(key, device)
    mantissa = (_bits(words, shape) >> 9) | _ONE_BITS
    lo, span = np.float32(minval), np.float32(maxval) - np.float32(minval)
    # XLA fuses ``floats * span + lo`` into one multiply-add: the product
    # of two f32 values is exact in float64, so one float64 add rounded
    # to f32 is that fused result.
    if not isinstance(mantissa, torch.Tensor):
        floats = np.asarray(mantissa).astype(np.uint32).view(np.float32) - np.float32(1.0)
        fused = (floats.astype(np.float64) * float(span) + float(lo)).astype(np.float32)
        return np.asarray(np.maximum(lo, fused))
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    fused = (floats.double() * float(span) + float(lo)).float()
    return torch.clamp_min(fused, float(lo))


def bernoulli(key: Key, p, shape: Sequence[int] | None = None, *, device=None):
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``): a
    uniform draw below ``p``, compared in f32.  ``p`` is a float or an
    f32 array or tensor broadcasting against the draw's shape; ``shape``
    defaults to ``p``'s."""
    if shape is None:
        shape = tuple(np.shape(p)) if not isinstance(p, torch.Tensor) else tuple(p.shape)
    u = uniform(key, shape, device=device)
    if not isinstance(u, torch.Tensor):
        return u < np.asarray(p, np.float32)
    if isinstance(p, torch.Tensor):
        return u < p.to(device=u.device, dtype=torch.float32)
    return u < float(np.float32(p))


#: XLA's f32 ``erf_inv`` (M. Giles' single-precision approximation), in
#: the order its polynomial is evaluated: w < 5, then w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: ``w = -log1p(-x*x)``, a degree-8 polynomial
    in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3`` evaluated with fused
    multiply-adds, times x; +-1 map to +-inf.  ``log1p``, ``sqrt`` and
    each fused step are computed in float64 and rounded once (torch's f32
    ``sqrt`` on the CPU is not always correctly rounded), so every device
    gives the same words; XLA's own ``log1p`` makes about 1% of them
    differ from jax's by 1-2 ulps."""
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    coef = [
        torch.where(small, float(np.float32(a)), float(np.float32(b))).double()
        for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)
    ]
    p = coef[0].float()
    for c in coef[1:]:
        p = (p.double() * w + c).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: Key, shape: Sequence[int] = (), dtype=torch.float32, *, device=None):
    """``jax.random.normal`` in f32: ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform on ``(nextafter(-1, 0), 1)``.  The uniforms are jax's bit for
    bit and ``erf_inv`` is XLA's polynomial (:func:`_erfinv_f32`): about
    99% of the normals are jax's words, the rest within 2 f32 ulps.  A
    numpy key's normals are computed in torch on the CPU."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, dtype, lo, 1.0, device=device)
    host = not isinstance(u, torch.Tensor)
    if host:
        u = torch.from_numpy(np.array(u, np.float32))
    out = float(np.float32(math.sqrt(2.0))) * _erfinv_f32(u)
    return out.numpy() if host else out

