"""The Gram kernels' arithmetic, emulated on the CPU: the split of each f32
operand into two TF32 halves and the 3xTF32 products, summed in chunks
and folded with Kahan compensation as ``csrc/gram.cuh`` does.

The chunk depth, the Kahan depth and the J slice length are read from
the header, so the emulation follows the source.  It cannot model the
tensor cores' f32 accumulation, which truncates where the emulation
rounds to nearest: a chunk's sum here is an f32 product of the chunk's
halves.  So these tests show that the split and the folding keep the
precision the kernel needs, and tell 3xTF32 from 1xTF32; the card tests
in ``tests/test_torch_cuda.py`` hold the kernel itself to the same bar.

Bar: within 8 f32 ulps (8 * 2**-24) of max|G| of a float64 Gram, as
``test_gram_sums_are_compensated`` holds the card's G.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build


def _constant(name):
    text = (_build.CSRC / "gram.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


FOLD, KAHAN, SLICE = _constant("kFold"), _constant("kKahan"), _constant("kSlice")
ULP = 2.0**-24


def tf32_rna(x):
    """f32 rounded to TF32 (10 stored significand bits, nearest, ties away
    from zero), by the kernel's bit operations."""
    bits = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) + 0x1000
    bits = bits & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def kahan_add(total, comp, part):
    y = part - comp
    t = total + y
    return t, (t - total) - y


def gram_emulated(y, products):
    """G = Y Y^T (no 1/mu) for y (n, J) f32 as the kernel sums it: per
    chunk of FOLD samples the f32 sum of the chosen products of halves,
    chunks added into ``mid`` and ``mid`` into (total, comp) every KAHAN
    samples, per J slice of SLICE samples where J > SLICE, and the slices
    added in order with Kahan compensation."""
    n, j = y.shape
    hi, lo = split(y)
    pad = -j % FOLD
    hi, lo = (torch.nn.functional.pad(a, (0, pad)) for a in (hi, lo))
    hi_c = hi.reshape(n, -1, FOLD).transpose(0, 1)
    lo_c = lo.reshape(n, -1, FOLD).transpose(0, 1)
    chunks = torch.zeros((hi_c.shape[0], n, n), dtype=torch.float32)
    if products == 3:
        chunks += lo_c @ hi_c.mT
        chunks += hi_c @ lo_c.mT
    chunks += hi_c @ hi_c.mT
    per_kahan, per_slice = KAHAN // FOLD, SLICE // FOLD
    slices = [chunks] if j <= SLICE else list(chunks.split(per_slice))
    parts = []
    for sl in slices:
        total = comp = mid = torch.zeros((n, n), dtype=torch.float32)
        for c in range(sl.shape[0]):
            mid = mid + sl[c]
            if (c + 1) % per_kahan == 0 or c + 1 == sl.shape[0]:
                total, comp = kahan_add(total, comp, mid)
                mid = torch.zeros_like(mid)
        parts.append(total - comp)
    if len(parts) == 1:
        return parts[0]
    total = comp = torch.zeros((n, n), dtype=torch.float32)
    for part in parts:
        total, comp = kahan_add(total, comp, part)
    return total - comp


def _relu_features(n, j, seed):
    rng = np.random.default_rng(seed)
    return torch.relu(torch.from_numpy(rng.standard_normal((n, j)).astype(np.float32)))


def _ulps(got, y):
    want = y.double() @ y.double().T
    return ((got.double() - want).abs().max() / (ULP * want.abs().max())).item()


def test_header_constants_nest():
    assert FOLD % 8 == 0 and KAHAN % FOLD == 0 and SLICE % KAHAN == 0


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e30])
def test_split_recovers_x_to_2_pow_minus_22(scale):
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100_000) * scale).astype(np.float32))
    hi, lo = split(x)
    for half in (hi, lo):
        assert (half.view(torch.int32) & 0x1FFF).eq(0).all()  # a TF32 value
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0**-22 * x.double().abs()).all()
    assert (hi.double() - x.double()).abs().max() > 2.0**-22 * x.double().abs().max()


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0**-10                      # a TF32 value's last bit
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23,
                      one + 2.0**-11, 0.0, -0.0], dtype=torch.float32)
    got = tf32_rna(x)
    want = torch.tensor([one, -one, 1.0, 1.0 + 2.0**-9, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("j", [3000, 60000])
def test_emulated_3xtf32_gram_within_8_ulps_of_float64(j):
    y = _relu_features(64, j, seed=10)
    assert _ulps(gram_emulated(y, products=3), y) <= 8


def test_emulated_1xtf32_gram_misses_the_bar():
    """One product of the hi halves keeps 11 bits per operand: the bar
    tells it apart from three products."""
    y = _relu_features(64, 60000, seed=10)
    assert _ulps(gram_emulated(y, products=1), y) > 8

