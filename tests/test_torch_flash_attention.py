"""repro_torch's flash_attention op on the CPU against ``repro``'s.

The same numpy q, k, v go through ``repro.kernels.flash_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it, or
its dense reference) and through the port's op, which takes its plain
version for CPU tensors.

GQA: the port's op takes k and v with fewer heads than q and reads KV
head h // (H / H_kv) in place; ``repro``'s kernel takes them repeated
(``jnp.repeat``), and both give the same result.

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

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_flash_ref
from repro.models import build_model as j_build_model
from repro.nn.attention import chunked_causal_attention as j_chunked
from repro_torch.configs import get_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import blocks, build_model
from repro_torch.nn.attention import chunked_causal_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
PALLAS_TOL = {"float32": 4e-4, "bfloat16": 4e-2}
REF_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(b, h, s, hd, seed, kv_heads=None):
    rng = np.random.default_rng(seed)
    shapes = [(b, h, s, hd)] + 2 * [(b, kv_heads or h, s, hd)]
    return [rng.standard_normal(shape).astype(np.float32) for shape in shapes]


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


@pytest.mark.parametrize("hd", [64, 120, 128])   # 128: Phi-3.5-MoE's and Mixtral-8x22B's
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 96])
def test_gqa_kv_read_in_place_matches_pallas_on_repeated_kv(window, dtype):
    """32 query heads over KV at 8 heads, H2O-Danube3-4B's grouping: the
    port's op on the 8 KV heads against ``repro``'s Pallas kernel on KV
    repeated to 32 heads with ``jnp.repeat``."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 32, 128, 64, seed=8, kv_heads=8), dtype)
    got = fa.flash_attention(q, k, v, window=window)
    assert got.shape == q.shape and got.dtype == DTYPES[dtype][1]
    jk, jv = (jnp.repeat(t, 4, axis=1) for t in (jk, jv))
    pallas = j_flash(jq, jk, jv, window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=PALLAS_TOL[dtype])
    _close_scaled(got, j_flash_ref(jq, jk, jv, window=window), REF_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 96])
def test_gqa_group_of_seven_matches_pallas_on_repeated_kv(window, dtype):
    """14 query heads of 64 over 2 KV heads, InternVL2-1B's grouping (7
    query heads a KV head), against ``repro``'s Pallas kernel on KV
    repeated to 14 heads."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(1, 14, 128, 64, seed=14, kv_heads=2), dtype)
    got = fa.flash_attention(q, k, v, window=window)
    assert got.shape == q.shape and got.dtype == DTYPES[dtype][1]
    jk, jv = (jnp.repeat(t, 7, axis=1) for t in (jk, jv))
    pallas = j_flash(jq, jk, jv, window=window, block_q=64, block_k=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=PALLAS_TOL[dtype])
    _close_scaled(got, j_flash_ref(jq, jk, jv, window=window), REF_TOL[dtype])


def test_gqa_rule_is_checked_on_the_plain_path_too():
    q = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="H % H_kv == 0"):
        fa.flash_attention(q, torch.zeros((1, 3, 8, 16)), torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="H % H_kv == 0"):
        fa.flash_attention(q, torch.zeros((1, 2, 8, 16)), torch.zeros((1, 1, 8, 16)))


def test_gqa_model_hands_the_op_its_kv_heads_unrepeated(monkeypatch):
    """The reduced H2O-Danube3-4B (4 query heads over 2 KV heads, window
    64) through the op matches ``repro``'s logits as before
    (``test_torch_transformer.py``'s 1e-5 x max|logits| in f32), and the
    op is handed k and v at 2 heads, not repeated to 4."""
    import dataclasses

    import jax

    over = dict(num_kv_heads=2, attn_chunk=128, use_pallas_kernels=True)
    jcfg = dataclasses.replace(j_get_config("h2o_danube3_4b").reduced(), **over)
    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), **over)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = transformer_params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, 512, (2, 128))
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    seen = []

    def spy(q, k, v, *, window=None):
        seen.append((q.shape[1], k.shape[1], v.shape[1]))
        return fa.flash_attention(q, k, v, window=window)

    monkeypatch.setattr(blocks, "flash_attention", spy)
    with torch.no_grad():
        got, _ = build_model(cfg).forward(params, {"tokens": torch.from_numpy(toks)})
    assert seen == [(4, 2, 2)] * cfg.num_layers
    _close_scaled(got, want, 1e-5)


# The card's bar for the kernel, per element (``test_torch_cuda.py``):
# |kernel - plain| <= rel |plain| + 1e-5 max|plain|, rel = 2**-7 in bf16.
def _close_flash(got, want, rel):
    got, want = got.float(), want.float()
    allowed = rel * want.abs() + 1e-5 * want.abs().max()
    excess = ((got - want).abs() - allowed).max().item()
    assert excess <= 0.0, excess


def _p_precision_case(s=2048, hd=120, seed=5):
    """``test_torch_cuda.py``'s case: bf16 q, k with logits of standard
    deviation 3 and V of +-(500..1500) on alternate keys."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(3**0.5 * rng.standard_normal((1, 2, s, hd)).astype(np.float32))
            for _ in range(2))
    sign = torch.where(torch.arange(s) % 2 == 0, 1.0, -1.0)[:, None]
    mag = torch.from_numpy(rng.uniform(500, 1500, (1, 2, 1, hd)).astype(np.float32))
    return [t.to(torch.bfloat16) for t in (q, k, sign * mag)]


def _emulate_pv(q, k, v, split):
    """The kernel's P V with p = exp(s - max) in f32 and l its f32 sum,
    p rounded to bf16 (``split=False``, FlashAttention-2's shortcut) or
    kept as bf16(p) + bf16(p - bf16(p)) (``split=True``, the kernel's two
    mmas); the products and sums in f64, so that only p's rounding shows."""
    s, hd = q.shape[-2:]
    logits = (q.float() * hd**-0.5) @ k.float().mT
    pos = torch.arange(s)
    logits = torch.where(pos[:, None] >= pos[None, :], logits, -torch.inf)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    hi = p.bfloat16()
    pe = hi.double() + ((p - hi.float()).bfloat16().double() if split else 0.0)
    return ((pe @ v.double()) / p.sum(-1, keepdim=True).double()).to(torch.bfloat16)


def test_p_precision_case_tells_bf16_p_from_split_p():
    """The card test ``test_flash_attention_bf16_keeps_p_precise`` has
    power: on its inputs, P V with p rounded to bf16 fails the card's bar
    (outputs that are small differences of +-1000 terms move by about 1),
    and P V with the hi/lo split passes it."""
    q, k, v = _p_precision_case()
    want = fa.flash_attention_ref(q, k, v)
    with pytest.raises(AssertionError):
        _close_flash(_emulate_pv(q, k, v, split=False), want, 2**-7)
    _close_flash(_emulate_pv(q, k, v, split=True), want, 2**-7)
