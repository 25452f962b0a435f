"""repro_torch's flash_attention op on the CPU against ``repro``'s.

The same numpy q, k, v go through ``repro.kernels.flash_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it, or
its dense reference) and through the port's op, which takes its plain
version for CPU tensors.

Tolerances: against the Pallas kernel, the reference's own sweep
tolerances (``test_kernels.py``: 4e-4 absolute in f32, 4e-2 in bf16,
for N(0, 1) inputs).  Against ``repro``'s dense reference, which does the
same arithmetic in another framework: 1e-5 x max|want| in f32 (a dot of
hd terms and a softmax over S keys, summed in other orders) and 1e-2 x
max|want| in bf16 (both round one f32 result to bf16, so they may differ
by one bf16 ulp, 2**-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.nn.attention import chunked_causal_attention as j_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.nn.attention import chunked_causal_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PALLAS_TOL = {"float32": 4e-4, "bfloat16": 4e-2}
REF_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(b, h, s, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, hd)).astype(np.float32) for _ in range(3)]


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_scaled(got, want, rel):
    got, want = _f32(got), _f32(want)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)


@pytest.mark.parametrize("hd", [64, 120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("s,block", [(128, 64), (256, 128), (256, 64)])
def test_plain_matches_pallas_and_reference(s, block, window, dtype, hd):
    (jq, jk, jv), (q, k, v) = _both(_inputs(2, 3, s, hd, seed=s + hd + (window or 0)), dtype)
    got = fa.flash_attention(q, k, v, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, 3, s, hd)
    pallas = j_flash(jq, jk, jv, window=window, block_q=block, block_k=block)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=PALLAS_TOL[dtype])
    _close_scaled(got, j_flash_ref(jq, jk, jv, window=window), REF_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 33])
@pytest.mark.parametrize("s", [1, 100])
def test_ragged_lengths_match_reference(s, window, dtype):
    """S not a multiple of any block: ``repro`` can only run its dense
    reference here, and the port's plain version agrees with it."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 2, s, 80, seed=s), dtype)
    got = fa.flash_attention(q, k, v, window=window)
    _close_scaled(got, j_flash_ref(jq, jk, jv, window=window), REF_TOL[dtype])


def test_matches_model_chunked_attention():
    """The op, in (B, H, S, hd), equals the model's chunked attention, in
    (B, S, H, hd), in both packages (``test_kernels.py``'s 5e-5)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 2, 128, 32, seed=9))
    op = fa.flash_attention(q, k, v, window=40).transpose(1, 2)
    t = [a.transpose(1, 2) for a in (q, k, v)]
    chunked = chunked_causal_attention(*t, chunk_size=48, window=40)
    np.testing.assert_allclose(op.numpy(), chunked.numpy(), atol=5e-5)
    j = j_chunked(*(jnp.asarray(a.numpy()) for a in t), chunk_size=64, window=40)
    np.testing.assert_allclose(op.numpy(), np.asarray(j), atol=5e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 50, 16, seed=1))
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, window=7)
    assert fa.launch_count() == before
    assert torch.equal(got, fa.flash_attention_ref(q, k, v, window=7))


def test_other_tensors_go_to_the_kernel_with_no_fallback():
    """A tensor that is not on the CPU never reaches the plain version:
    the kernel's wrapper takes it and raises on what it cannot run."""
    q = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, torch.zeros((1, 2, 8, 16)), q)


def test_reference_chunks_slices_without_changing_the_result(monkeypatch):
    from repro_torch.kernels.flash_attention import ref

    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 3, 40, 8, seed=2))
    whole = ref.flash_attention_ref(q, k, v, window=9)
    monkeypatch.setattr(ref, "_MAX_SCORES", 2 * 40 * 40)   # two slices at a time
    np.testing.assert_allclose(ref.flash_attention_ref(q, k, v, window=9).numpy(),
                               whole.numpy(), rtol=0, atol=1e-6)
