"""The port's CUDA legs: they need an NVIDIA GPU and skip without one.

This file imports neither JAX nor ``repro``, so it also runs on a host
that has only the port's dependencies:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: f32 rtol/atol 1e-5 against the plain version (both sum in
f32, in different orders); bf16 one bf16 ulp, 2**-7 relative, since both
round an f32 sum to bf16 and two orders may leave it on either side of a
rounding boundary.  The Gram kernels are held at 1e-5 x max|G| (their
sums run over J <= 3000 samples; for J = 60000 at 2 sqrt(J) 2**-24 x
max|G| = 2.9e-5, the random-walk growth of an in-order f32 sum of J
terms, which the library GEMM behind the plain version may take).  A bf16 propagate_gram
rounds Y' (one bf16 ulp) but builds G from the f32 Y' in both versions,
so its G keeps the f32 tolerance.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn
from repro_torch.kernels import gram as gram_mod
from repro_torch.kernels import propagate_gram as pg_mod
from repro_torch.kernels.matmul_relu import (
    launch_count,
    matmul_relu,
    matmul_relu_cuda,
    matmul_relu_ref,
)
from repro_torch.serve import MicroBatcher, ServeEngine, export_artifact

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((m, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((k, n)).astype(np.float32)
    return w, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "m,k,n",
    [(1020, 784, 1), (1020, 1020, 8), (1020, 1020, 32), (1020, 1020, 128),
     (1204, 3000, 77), (1, 1, 1), (33, 257, 65)],
)
def test_kernel_matches_plain(cuda, dtype, m, k, n):
    w, x = _operands(m, k, n)
    tw = torch.from_numpy(w).to(cuda, dtype)
    tx = torch.from_numpy(x).to(cuda, dtype)
    before = launch_count()
    got = matmul_relu(tw, tx)
    torch.cuda.synchronize()
    assert launch_count() == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = matmul_relu_ref(tw, tx)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_kernel_keeps_nan(cuda):
    w = torch.tensor([[1.0, 0.0], [-1.0, 0.0]], device=cuda)
    x = torch.tensor([[float("nan")], [1.0]], device=cuda)
    assert torch.isnan(matmul_relu(w, x)).all()


@pytest.mark.cuda
def test_kernel_columns_independent_of_batch_width(cuda):
    """Padding invariance: a column's bits do not depend on n, whatever
    tile shape that n selects."""
    w, x = _operands(1020, 1020, 128)
    tw, tx = torch.from_numpy(w).to(cuda), torch.from_numpy(x).to(cuda)
    full = matmul_relu(tw, tx)
    for n in (1, 8, 16, 17, 32, 64, 65):
        assert torch.equal(matmul_relu(tw, tx[:, :n].contiguous()), full[:, :n]), n


@pytest.mark.cuda
def test_wrapper_rejects_what_kernel_cannot_take(cuda):
    w = torch.zeros((4, 3), device=cuda)
    x = torch.zeros((3, 2), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        matmul_relu_cuda(w.half(), x.half())
    with pytest.raises(TypeError, match="dtype"):
        matmul_relu_cuda(w, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        matmul_relu_cuda(w, torch.zeros((2, 3), device=cuda).t())
    with pytest.raises(ValueError, match=r"\(k, n\)"):
        matmul_relu_cuda(w, torch.zeros((4, 2), device=cuda))
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_relu_cuda(w, x.cpu())


@pytest.mark.cuda
def test_engine_on_card_launches_kernel_per_layer_and_stays_bit_exact(cuda, tmp_path):
    rng = np.random.default_rng(1)
    p, q, n, layers = 784, 10, 1020, 3
    o = [rng.standard_normal((q, p)).astype(np.float32) / 28]
    o += [rng.standard_normal((q, n)).astype(np.float32) / 32 for _ in range(layers)]
    r = [(rng.standard_normal((n - 2 * q, p if l == 0 else n)) / 32).astype(np.float32)
         for l in range(layers)]
    path = str(tmp_path / "stack")
    export_artifact(path, params_from_numpy(o, r, device="cpu"))
    engine = ServeEngine(path, buckets=(8, 32))
    assert engine.device.type == "cuda"
    x = torch.from_numpy(rng.standard_normal((p, 32)).astype(np.float32))
    before = launch_count()
    full = engine.forward(x)
    assert launch_count() == before + layers
    assert torch.equal(full, ssfn.predict(params_from_numpy(o, r, device=cuda), x.to(cuda), q))
    assert torch.equal(engine.forward(x[:, :5]), full[:, :5])
    batcher = MicroBatcher(engine, max_batch=32, max_wait_us=1e9)
    handles = [batcher.submit(x[:, i:i + 1]) for i in range(32)]
    assert torch.equal(torch.cat([h.result() for h in handles], dim=1), full)
    cpu = ServeEngine(path, buckets=(8, 32), device="cpu").forward(x)
    np.testing.assert_allclose(full.cpu().numpy(), cpu.numpy(), **TOL)


# ---------------------------------------------------------------------------
# gram and propagate_gram
# ---------------------------------------------------------------------------


def _gram_tol(j):
    return max(1e-5, 2 * math.sqrt(j) * 2**-24)


def _close_scaled(got, want, rel):
    """max|got - want| <= rel * max|want|, in f32."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= rel * scale, (err, rel * scale)


def _features(m, n, j, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n, j)).astype(np.float32)


# (M, n, J): the train's layer-0 launches (decentralized and centralized),
# a full-width propagated layer, and ragged edges.
GRAM_SHAPES = [(20, 784, 3000), (1, 784, 60000), (20, 1020, 3000),
               (3, 33, 65), (1, 1, 1), (2, 130, 31)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,j", GRAM_SHAPES)
def test_gram_matches_plain(cuda, m, n, j):
    y = torch.from_numpy(_features(m, n, j)).to(cuda)
    before = gram_mod.launch_count()
    got = gram_mod.gram(y, mu=1e-3)
    torch.cuda.synchronize()
    assert gram_mod.launch_count() == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n, n)
    _close_scaled(got, gram_mod.gram_ref(y, mu=1e-3), _gram_tol(j))


@pytest.mark.cuda
def test_gram_sums_are_compensated(cuda):
    """60000 non-negative products per entry (ReLU features, the
    centralized layer): the kernel's Kahan-added 32-term chains stay
    within 8 f32 ulps of max|G| of a float64 Gram, where one in-order
    chain drifts by about sqrt(J/3) = 141 ulps."""
    y = torch.relu(torch.from_numpy(_features(1, 64, 60000, seed=10))).to(cuda)
    got = gram_mod.gram(y, mu=1.0).double()
    y64 = y.double()
    want = y64 @ y64.mT + torch.eye(64, dtype=torch.float64, device=cuda)
    assert (got - want).abs().max().item() <= 8 * 2**-24 * want.abs().max().item()


@pytest.mark.cuda
def test_gram_bf16_matches_plain(cuda):
    y = torch.from_numpy(_features(3, 33, 65)).to(cuda, torch.bfloat16)
    got = gram_mod.gram(y, mu=1.0)
    assert got.dtype == torch.float32
    _close_scaled(got, gram_mod.gram_ref(y, mu=1.0), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,j", [(3, 200, 300), (3, 1020, 257), (20, 784, 3000)])
def test_gram_symmetric_and_deterministic(cuda, m, n, j):
    """Exactly symmetric; bit-identical across calls, across batch
    positions, and whether a worker is computed at M=1 or in a batch."""
    y = torch.from_numpy(_features(m, n, j, seed=2)).to(cuda)
    g1 = gram_mod.gram(y, mu=0.5)
    g2 = gram_mod.gram(y, mu=0.5)
    assert torch.equal(g1, g2)
    assert torch.equal(g1, g1.mT)
    rolled = gram_mod.gram(torch.roll(y, 1, dims=0).contiguous(), mu=0.5)
    assert torch.equal(torch.roll(rolled, -1, dims=0), g1)
    for w in range(m):
        assert torch.equal(gram_mod.gram(y[w:w + 1].contiguous(), mu=0.5)[0], g1[w])


# (n, n_prev, M, J): the train's layer-1 and layer-l launches, decentralized
# and centralized, and ragged edges.
PROPAGATE_SHAPES = [(1020, 784, 20, 3000), (1020, 1020, 20, 3000),
                    (1020, 1020, 1, 60000), (33, 257, 3, 65), (1, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_prev,m,j", PROPAGATE_SHAPES)
def test_propagate_gram_matches_plain(cuda, n, n_prev, m, j):
    rng = np.random.default_rng(3)
    w = torch.from_numpy(
        (rng.standard_normal((n, n_prev)) / np.sqrt(n_prev)).astype(np.float32)
    ).to(cuda)
    y = torch.from_numpy(_features(m, n_prev, j, seed=4)).to(cuda)
    before = pg_mod.launch_count()
    y_new, g = pg_mod.propagate_gram(w, y, mu=1.0)
    torch.cuda.synchronize()
    assert pg_mod.launch_count() == before + 1
    assert y_new.shape == (m, n, j) and g.shape == (m, n, n)
    want_y, want_g = pg_mod.propagate_gram_ref(w, y, mu=1.0)
    _close_scaled(y_new, want_y, 1e-5)
    _close_scaled(g, want_g, _gram_tol(j))
    assert torch.equal(g, g.mT)
    assert (y_new >= 0).all()


@pytest.mark.cuda
def test_propagate_gram_bf16_grams_the_unrounded_features(cuda):
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((33, 257)).astype(np.float32) / 16)
    y = torch.from_numpy(_features(3, 257, 65, seed=6))
    w, y = w.to(cuda, torch.bfloat16), y.to(cuda, torch.bfloat16)
    y_new, g = pg_mod.propagate_gram(w, y, mu=1.0)
    want_y, want_g = pg_mod.propagate_gram_ref(w, y, mu=1.0)
    assert y_new.dtype == torch.bfloat16 and g.dtype == torch.float32
    _close_scaled(y_new, want_y, 1e-2)
    _close_scaled(g, want_g, 1e-5)          # f32: G saw no bf16 rounding
    # The tolerance tells the two apart: a Gram of the rounded Y' misses it.
    rounded = want_y.float()
    g_rounded = torch.matmul(rounded, rounded.mT) + torch.eye(33, device=cuda)
    assert (g_rounded - want_g).abs().max() > 1e-5 * want_g.abs().max()


@pytest.mark.cuda
def test_propagate_gram_deterministic_per_worker(cuda):
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32) / 14).to(cuda)
    y = torch.from_numpy(_features(3, 200, 129, seed=8)).to(cuda)
    y1, g1 = pg_mod.propagate_gram(w, y, mu=1.0)
    y2, g2 = pg_mod.propagate_gram(w, y, mu=1.0)
    assert torch.equal(y1, y2) and torch.equal(g1, g2)
    y_one, g_one = pg_mod.propagate_gram(w, y[2:].contiguous(), mu=1.0)
    assert torch.equal(y_one[0], y1[2]) and torch.equal(g_one[0], g1[2])
    # The Gram pass of the fused op is the gram kernel on the f32 Y'.
    assert torch.equal(gram_mod.gram(y1, mu=1.0), g1)


@pytest.mark.cuda
def test_gram_wrappers_reject_what_kernels_cannot_take(cuda):
    y = torch.zeros((2, 4, 3), device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gram_mod.gram_cuda(y.half(), mu=1.0)
    with pytest.raises(ValueError, match=r"\(M, n, J\)"):
        gram_mod.gram_cuda(y[0], mu=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        gram_mod.gram_cuda(y.mT, mu=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        gram_mod.gram_cuda(y.cpu(), mu=1.0)
    w = torch.zeros((5, 4), device=cuda)
    with pytest.raises(ValueError, match="n_prev"):
        pg_mod.propagate_gram_cuda(w, torch.zeros((2, 3, 3), device=cuda), mu=1.0)
    with pytest.raises(TypeError, match=r"one\s+dtype"):
        pg_mod.propagate_gram_cuda(w, y.to(torch.bfloat16), mu=1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        pg_mod.propagate_gram_cuda(w, y.cpu(), mu=1.0)


# ---------------------------------------------------------------------------
# The training slice on the card
# ---------------------------------------------------------------------------


def _train_inputs(device):
    """test_torch_train.py's geometry: P=32, Q=4, n=128, L=3, M=4, J=1024,
    K=30, mu0 = mul = 1e-1, from numpy so both devices get the same data
    and the same R."""
    rng = np.random.default_rng(9)
    p, q, n, layers, m, j = 32, 4, 128, 3, 4, 1024
    x = rng.standard_normal((p, j)).astype(np.float32)
    labels = rng.integers(0, q, j)
    t = np.eye(q, dtype=np.float32)[labels].T.copy()
    r = [(rng.standard_normal((n - 2 * q, p if l == 0 else n)) / np.sqrt(p if l == 0 else n))
         .astype(np.float32) for l in range(layers)]
    cfg = ssfn.SSFNConfig(input_dim=p, num_classes=q, num_layers=layers, hidden=n,
                          mu0=1e-1, mul=1e-1, admm_iters=30)
    xw = torch.from_numpy(x.reshape(p, m, j // m).transpose(1, 0, 2).copy()).to(device)
    tw = torch.from_numpy(t.reshape(q, m, j // m).transpose(1, 0, 2).copy()).to(device)
    return cfg, xw, tw, [torch.from_numpy(a).to(device) for a in r], torch.from_numpy(x).to(device)


@pytest.mark.cuda
def test_card_training_run_equals_cpu_run(cuda):
    """Within test_torch_train.py's tolerances: readouts and predictions
    within a relative gap of 1e-4, argmax agreement >= 0.99; the train
    launches gram once and propagate_gram once per propagated layer."""
    from repro_torch.core import layerwise

    cfg, xw, tw, r, x = _train_inputs(cuda)
    g0, p0 = gram_mod.launch_count(), pg_mod.launch_count()
    card, card_log = layerwise.train_decentralized_ssfn(xw, tw, cfg, r=r)
    assert gram_mod.launch_count() == g0 + 1
    assert pg_mod.launch_count() == p0 + cfg.num_layers
    cfg_c, xw_c, tw_c, r_c, x_c = _train_inputs("cpu")
    cpu, cpu_log = layerwise.train_decentralized_ssfn(xw_c, tw_c, cfg_c, r=r_c)
    for a, b in zip(card.o, cpu.o):
        a, b = a.cpu().double(), b.double()
        assert float((a - b).norm() / b.norm()) <= 1e-4
    got, want = ssfn.predict(card, x, 4).cpu(), ssfn.predict(cpu, x_c, 4)
    assert float((got - want).norm() / want.norm()) <= 1e-4
    assert (got.argmax(0) == want.argmax(0)).float().mean() >= 0.99
    assert card_log.comm_scalars == cpu_log.comm_scalars
    assert np.array_equal(card_log.jitter_levels, cpu_log.jitter_levels)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# Tolerances, per element: |kernel - plain| <= rel |plain| + 1e-5 max|plain|.
# The second term is f32's (both sum in f32, a dot of hd <= 128 terms and
# a softmax over <= S keys, in different orders: a few ulps of the largest
# output).  bf16 adds rel = 2**-7: both round one f32 result to bf16, so
# an element whose f32 values straddle a rounding boundary may differ by
# one bf16 ulp, at most 2**-7 of its size.  Held per element, not against
# max|plain|: a long row averages over thousands of keys and is some 100x
# smaller than the first rows, so a global bf16 limit would let a dropped
# or mis-weighted KV tile there pass.
FLASH_REL = {torch.float32: 0.0, torch.bfloat16: 2**-7}


def _close_flash(got, want, dtype):
    got, want = got.float(), want.float()
    allowed = FLASH_REL[dtype] * want.abs() + 1e-5 * want.abs().max()
    excess = ((got - want).abs() - allowed).max().item()
    assert excess <= 0.0, excess


def _qkv(b, h, s, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, hd)).astype(np.float32))
            .to(device, dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 96, 4096])
@pytest.mark.parametrize("s", [1, 77, 128, 4100])
@pytest.mark.parametrize("hd", [64, 80, 120, 128])
def test_flash_attention_matches_plain(cuda, hd, s, window, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, h = (2, 3) if s <= 128 else (1, 2)
    q, k, v = _qkv(b, h, s, hd, dtype, cuda, seed=hd + s)
    before = fa.launch_count()
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launch_count() == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _close_flash(got, fa.flash_attention_ref(q, k, v, window=window), dtype)


@pytest.mark.cuda
def test_flash_attention_bit_identical_across_launches(cuda):
    from repro_torch.kernels import flash_attention as fa

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(1, 4, 1000, 120, dtype, cuda, seed=3)
        first = fa.flash_attention_cuda(q, k, v, window=300)
        second = fa.flash_attention_cuda(q, k, v, window=300)
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_attention_rejects_what_kernel_cannot_take(cuda):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(1, 2, 8, 16, torch.float32, cuda)
    big = torch.zeros((1, 2, 8, 129), device=cuda)
    with pytest.raises(ValueError, match="hd <= 128"):
        fa.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_cuda(q, k.cpu(), v)
    with pytest.raises(TypeError, match="one\\s+dtype"):
        fa.flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_cuda(q, k, v, window=0)
    for hd, dtype in ((33, torch.float32), (100, torch.bfloat16)):  # rows off 16 bytes
        odd = torch.zeros((1, 2, 8, hd), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_cuda(odd, odd, odd)
    buf = torch.zeros(q.numel() + 1, device=cuda)
    shifted = buf[1:].view(q.shape)             # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_cuda(shifted, k, v)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [77, 128, 200])
def test_transformer_forward_on_card_launches_kernel_per_layer(cuda, s):
    """A reduced H2O-Danube3-4B (GQA, window 64) forward on the card: one
    kernel launch per layer at every S, and the same logits as the plain
    chunked route and as the CPU (``test_kernel_integration.py``'s 5e-3;
    both f32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), num_kv_heads=2,
                              use_pallas_kernels=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(s).integers(0, 512, (2, s))).to(cuda)
    before = fa.launch_count()
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": toks})
        torch.cuda.synchronize()
        assert fa.launch_count() == before + cfg.num_layers
        plain, _ = build_model(dataclasses.replace(cfg, use_pallas_kernels=False)).forward(
            params, {"tokens": toks})
        cpu, _ = model.forward(_tree_to(params, "cpu"), {"tokens": toks.cpu()})
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), atol=5e-3)


@pytest.mark.cuda
def test_prefill_and_decode_step_never_wait_for_the_card(cuda):
    """No host synchronisation inside prefill or a decode step (a device
    tensor built from a host value, ``.item()``, a pageable copy): the host
    can enqueue the next step while the card runs this one."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("h2o_danube3_4b").reduced(), num_kv_heads=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 80))).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": toks}, max_len=84)
            for t in range(3):
                _, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]}, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert cache.index.tolist() == [83] * cfg.num_layers
