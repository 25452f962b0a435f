"""repro_torch.serve against repro.serve, on the CPU.

- Artifacts round-trip between the packages with bit-equal weights, and
  the port's loader survives the reference's corruption drills.
- ``ServeEngine(device="cpu")`` agrees with ``repro``'s engine, with
  ``use_kernels`` off and on (the Pallas kernel in interpret mode on a
  128-aligned stack), to rtol/atol 1e-5: both sum in f32 through
  different GEMMs, so the sums round in another order.
- Within the port, bucketed, padded, chunked and micro-batched forwards
  are bit-identical to serving the same bucket directly, and the engine
  equals the port's ``ssfn.predict`` bit for bit at J == bucket.
- The bucket-program cache keeps ``repro``'s ``cache_info`` schema.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dssfn
from repro.core import ssfn as jssfn
from repro.serve import ServeEngine as JServeEngine
from repro.serve import export_artifact as j_export
from repro.serve import load_artifact as j_load
from repro_torch.convert import params_from_numpy
from repro_torch.core import ssfn as tssfn
from repro_torch.serve import (
    ArtifactCorruptError,
    MicroBatcher,
    PendingResult,
    RequestError,
    ServeEngine,
    export_artifact,
    is_valid_artifact,
    load_artifact,
    pack_fifo,
    parse_features,
    size_bucket,
)
from repro_torch.serve.export import MANIFEST_NAME, WEIGHTS_NAME

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_stack(p, q, n, layers, seed=0):
    rng = np.random.default_rng(seed)

    def draw(rows, fan_in):
        return (rng.standard_normal((rows, fan_in)) / np.sqrt(fan_in)).astype(np.float32)

    o = [draw(q, p)] + [draw(q, n) for _ in range(layers)]
    r = [draw(n - 2 * q, p if l == 0 else n) for l in range(layers)]
    return o, r


def _jparams(o, r):
    return jssfn.SSFNParams(o=tuple(map(jnp.asarray, o)), r=tuple(map(jnp.asarray, r)))


@pytest.fixture(scope="module")
def trained():
    """A stack the reference trained (tests/test_serve.py's geometry:
    P=8, Q=3, n=20, L=2, 4 simulated workers)."""
    kx, kt = jax.random.split(jax.random.PRNGKey(0))
    xw = jax.random.normal(kx, (4, 8, 16))
    tw = jax.nn.one_hot(jax.random.randint(kt, (4, 16), 0, 3), 3).transpose(0, 2, 1)
    cfg = jssfn.SSFNConfig(input_dim=8, num_classes=3, num_layers=2, hidden=20, admm_iters=30)
    spec = dssfn.TrainSpec(cfg=cfg, backend="simulated", workers=4)
    return dssfn.train(spec, xw, tw, jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def artifact_dir(trained, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tserve") / "stack")
    j_export(path, trained)
    return path


def _x(p, j, seed):
    return np.random.default_rng(seed).standard_normal((p, j)).astype(np.float32)


# ---------------------------------------------------------------------------
# Round trips between the packages
# ---------------------------------------------------------------------------


def test_repro_artifact_loads_in_port_bit_exact(trained, artifact_dir):
    art = load_artifact(artifact_dir)
    assert (art.num_classes, art.input_dim, art.num_layers) == (3, 8, 2)
    assert art.features is None and art.version == 1
    for a, b in zip(art.params.o + art.params.r, trained.params.o + trained.params.r):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert art.describe() == j_load(artifact_dir).describe()


def test_port_artifact_loads_in_repro_bit_exact(tmp_path):
    o, r = _np_stack(8, 3, 20, 2)
    path = str(tmp_path / "port")
    export_artifact(path, params_from_numpy(o, r, device="cpu"), source="test")
    art = j_load(path)
    for a, b in zip(art.params.o + art.params.r, o + r):
        assert np.array_equal(np.asarray(a), b)
    jpath = str(tmp_path / "ref")
    j_export(jpath, _jparams(o, r), source="test")
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        t_manifest = json.load(f)
    with open(os.path.join(jpath, MANIFEST_NAME)) as f:
        j_manifest = json.load(f)
    assert t_manifest == j_manifest


def test_export_accepts_params_and_result(tmp_path):
    class Result:
        def __init__(self, params):
            self.params = params

    o, r = _np_stack(8, 3, 20, 1)
    tp = params_from_numpy(o, r, device="cpu")
    export_artifact(str(tmp_path / "a"), tp)
    export_artifact(str(tmp_path / "b"), Result(tp))
    for x, y in zip(load_artifact(str(tmp_path / "a")).params.o,
                    load_artifact(str(tmp_path / "b")).params.o):
        assert torch.equal(x, y)


def test_export_rejects_non_params(tmp_path):
    with pytest.raises(TypeError, match="SSFNParams"):
        export_artifact(str(tmp_path / "bad"), {"o": [], "r": []})


def test_export_validates_feature_spec_eagerly(tmp_path):
    o, r = _np_stack(8, 3, 20, 1)
    with pytest.raises(ValueError, match="feature spec"):
        export_artifact(str(tmp_path / "bad"), params_from_numpy(o, r, device="cpu"),
                        features="rff")
    assert not os.path.exists(str(tmp_path / "bad"))


def test_export_rejects_broken_shape_chain(tmp_path):
    o, r = _np_stack(8, 3, 20, 2)
    r[1] = r[1][:, :-1]
    with pytest.raises(ArtifactCorruptError, match="r/1"):
        export_artifact(str(tmp_path / "bad"), params_from_numpy(o, r, device="cpu"))


# ---------------------------------------------------------------------------
# Corruption drills (mirrors tests/test_serve.py)
# ---------------------------------------------------------------------------


def _copy_artifact(src, dst):
    os.makedirs(dst, exist_ok=True)
    for name in (MANIFEST_NAME, WEIGHTS_NAME, WEIGHTS_NAME + ".meta.json"):
        with open(os.path.join(src, name), "rb") as f:
            blob = f.read()
        with open(os.path.join(dst, name), "wb") as f:
            f.write(blob)
    return dst


def _edit_manifest(path, **changes):
    mpath = os.path.join(path, MANIFEST_NAME)
    with open(mpath) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def test_valid_artifact_is_valid(artifact_dir):
    assert is_valid_artifact(artifact_dir)


def test_missing_dir_invalid(tmp_path):
    assert not is_valid_artifact(str(tmp_path / "nothing"))
    with pytest.raises(ArtifactCorruptError):
        load_artifact(str(tmp_path / "nothing"))


@pytest.mark.parametrize("name", [MANIFEST_NAME, WEIGHTS_NAME, WEIGHTS_NAME + ".meta.json"])
def test_missing_file_invalid(artifact_dir, tmp_path, name):
    bad = _copy_artifact(artifact_dir, str(tmp_path / "missing"))
    os.remove(os.path.join(bad, name))
    assert not is_valid_artifact(bad)
    with pytest.raises(ArtifactCorruptError):
        load_artifact(bad)


def test_truncated_weights_invalid(artifact_dir, tmp_path):
    bad = _copy_artifact(artifact_dir, str(tmp_path / "truncated"))
    wpath = os.path.join(bad, WEIGHTS_NAME)
    with open(wpath, "rb") as f:
        blob = f.read()
    with open(wpath, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert not is_valid_artifact(bad)


def test_garbage_manifest_invalid(artifact_dir, tmp_path):
    bad = _copy_artifact(artifact_dir, str(tmp_path / "garbage"))
    with open(os.path.join(bad, MANIFEST_NAME), "w") as f:
        f.write("{not json")
    assert not is_valid_artifact(bad)


@pytest.mark.parametrize(
    "changes,match",
    [
        ({"version": 999}, "version"),
        ({"format": "other"}, "format"),
        ({"activation": "tanh"}, "activation"),
        ({"num_readouts": "3"}, "num_readouts"),
        ({"num_classes": 4}, "manifest records"),
        ({"num_readouts": 4}, "missing required"),
        ({"features": "fourier:8"}, "feature spec"),
    ],
)
def test_manifest_defects_invalid(artifact_dir, tmp_path, changes, match):
    bad = _copy_artifact(artifact_dir, str(tmp_path / "defect"))
    _edit_manifest(bad, **changes)
    assert not is_valid_artifact(bad)
    with pytest.raises(ArtifactCorruptError, match=match):
        load_artifact(bad)


def test_engine_refuses_corrupt_artifact(artifact_dir, tmp_path):
    bad = _copy_artifact(artifact_dir, str(tmp_path / "engine_corrupt"))
    os.remove(os.path.join(bad, WEIGHTS_NAME))
    with pytest.raises(ArtifactCorruptError):
        ServeEngine(bad, device="cpu")


# ---------------------------------------------------------------------------
# Parity with repro's engine
# ---------------------------------------------------------------------------


def test_engine_matches_reference_engine_on_trained_stack(artifact_dir):
    x = _x(8, 16, 0)
    want = np.asarray(JServeEngine(artifact_dir, buckets=(4, 16)).forward(x))
    engine = ServeEngine(artifact_dir, buckets=(4, 16), device="cpu")
    np.testing.assert_allclose(engine.forward(x).numpy(), want, **TOL)
    np.testing.assert_allclose(engine.forward(x[:, :3]).numpy(), want[:, :3], **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_engine_matches_reference_on_aligned_stack(use_kernels, tmp_path):
    """P=128, Q=4, n=256, L=2 at bucket 128: every propagation shape is
    128-aligned, so use_kernels=True runs repro's Pallas kernel (in
    interpret mode on the CPU)."""
    o, r = _np_stack(128, 4, 256, 2, seed=4)
    path = str(tmp_path / "aligned")
    j_export(path, _jparams(o, r))
    x = _x(128, 128, 5)
    ref_engine = JServeEngine(path, buckets=(128,), use_kernels=use_kernels)
    want = np.asarray(ref_engine.forward(x))
    got = ServeEngine(path, buckets=(128,), device="cpu").forward(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_engine_bit_exact_vs_port_predict(trained, artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(16,), device="cpu")
    x = _x(8, 16, 1)
    tp = params_from_numpy(
        [np.asarray(o) for o in trained.params.o],
        [np.asarray(r) for r in trained.params.r], device="cpu",
    )
    ref = tssfn.predict(tp, torch.from_numpy(x), 3)
    assert torch.equal(engine.forward(x), ref)
    assert torch.equal(engine.classify(x), torch.argmax(ref, dim=0))


def test_engine_bf16_tracks_f32(artifact_dir):
    x = _x(8, 8, 2)
    f32 = ServeEngine(artifact_dir, buckets=(8,), device="cpu").forward(x)
    bf16 = ServeEngine(artifact_dir, buckets=(8,), device="cpu", dtype=torch.bfloat16).forward(x)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), f32.numpy(), rtol=5e-2, atol=5e-2)


def test_engine_without_device_needs_cuda(artifact_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(artifact_dir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(artifact_dir, device="cuda")


def test_engine_rejects_wrong_input_dim(artifact_dir):
    engine = ServeEngine(artifact_dir, device="cpu")
    with pytest.raises(ValueError, match="feature rows"):
        engine.forward(np.zeros((9, 4), np.float32))
    with pytest.raises(ValueError, match="column-stacked"):
        engine.forward(np.zeros((8, 4, 1), np.float32))


# ---------------------------------------------------------------------------
# Reload
# ---------------------------------------------------------------------------


def test_reload_hot_swap_no_new_lowering(artifact_dir, tmp_path):
    engine = ServeEngine(artifact_dir, buckets=(4, 16), device="cpu")
    x = _x(8, 16, 5)
    engine.forward(x)
    lowerings = engine.lowerings
    o, r = _np_stack(8, 3, 20, 2, seed=7)
    path = str(tmp_path / "newer")
    export_artifact(path, params_from_numpy(o, r, device="cpu"))
    engine.reload(path)
    out = engine.forward(x)
    assert engine.lowerings == lowerings, "reload must not add a lowering"
    assert torch.equal(out, tssfn.predict(params_from_numpy(o, r, device="cpu"),
                                          torch.from_numpy(x), 3))


@pytest.mark.parametrize("change", ["hidden", "features"])
def test_reload_rejects_shape_or_feature_change(artifact_dir, tmp_path, change):
    engine = ServeEngine(artifact_dir, device="cpu")
    before = [w.clone() for w in engine._weights]
    o, r = _np_stack(8, 3, 24 if change == "hidden" else 20, 2, seed=8)
    path = str(tmp_path / "other")
    export_artifact(path, params_from_numpy(o, r, device="cpu"),
                    features="rff:8" if change == "features" else None)
    with pytest.raises(ValueError, match="mismatch"):
        engine.reload(path)
    assert all(torch.equal(a, b) for a, b in zip(before, engine._weights))


# ---------------------------------------------------------------------------
# Batching invariance + bucket-program counts
# ---------------------------------------------------------------------------


def test_padded_bucketed_execution_bit_exact(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(8,), device="cpu")
    x = _x(8, 8, 2)
    full = engine.forward(x)
    assert torch.equal(engine.forward(x[:, :5]), full[:, :5])
    assert engine.lowerings == 1


def test_single_sample_vs_batch_bit_exact(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(8,), device="cpu")
    x = _x(8, 8, 3)
    full = engine.forward(x)
    for i in range(8):
        assert torch.equal(engine.forward(x[:, i])[:, 0], full[:, i])
    assert engine.lowerings == 1


def test_chunked_oversize_batch_bit_exact(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(4,), device="cpu")
    x = _x(8, 10, 4)
    out = engine.forward(x)
    assert out.shape == (3, 10)
    by_hand = torch.cat(
        [engine.forward(x[:, 0:4]), engine.forward(x[:, 4:8]), engine.forward(x[:, 8:10])],
        dim=1,
    )
    assert torch.equal(out, by_hand)
    assert engine.lowerings == 1


def test_two_buckets_cost_exactly_two_lowerings(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(2, 16), device="cpu")
    rng = np.random.default_rng(0)
    for j in (1, 2, 1, 5, 16, 3, 2, 9, 16, 1):
        engine.forward(rng.standard_normal((8, j)).astype(np.float32))
    info = engine.cache_info()
    assert info["lowerings"] == 2, info
    assert sorted(info["buckets"]) == [2, 16]
    assert info["cache_hits"] == 8, info
    ref_keys = JServeEngine(artifact_dir, buckets=(2, 16)).cache_info().keys()
    assert set(info) == set(ref_keys)
    assert info["entries"] == len(info["keys"]) == 2
    assert "(2, 'float32')" in info["keys"]


def test_distinct_dtypes_get_distinct_programs(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(8,), device="cpu")
    x32 = np.zeros((8, 8), np.float32)
    engine.forward(x32)
    engine.forward(x32.astype(np.float16))
    assert engine.lowerings == 2


def test_micro_batched_results_bit_exact(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(8,), device="cpu")
    x = _x(8, 8, 6)
    full = engine.forward(x)
    batcher = MicroBatcher(engine, max_batch=8, max_wait_us=1e9)
    handles = [batcher.submit(x[:, i:i + 1]) for i in range(8)]
    assert all(h.done() for h in handles)
    got = torch.cat([h.result() for h in handles], dim=1)
    assert torch.equal(got, full)
    assert engine.lowerings == 1


# ---------------------------------------------------------------------------
# Micro-batcher admission (mirrors tests/test_serve.py)
# ---------------------------------------------------------------------------


def test_batcher_max_batch_admission(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(4,), device="cpu")
    batcher = MicroBatcher(engine, max_batch=4, max_wait_us=1e9)
    hs = [batcher.submit(np.zeros((8, 1), np.float32)) for _ in range(3)]
    assert not any(h.done() for h in hs)
    assert batcher.pending() == 3
    h4 = batcher.submit(np.zeros((8, 1), np.float32))
    assert all(h.done() for h in hs) and h4.done()
    assert batcher.pending() == 0
    assert batcher.stats["batches"] == 1
    assert batcher.stats["batch_size_hist"] == {4: 1}


def test_batcher_zero_wait_flushes_every_submit(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(4,), device="cpu")
    batcher = MicroBatcher(engine, max_batch=4, max_wait_us=0.0)
    snap = dict(batcher.stats)
    for _ in range(3):
        assert batcher.submit(np.zeros((8, 1), np.float32)).done()
    assert batcher.stats["batches"] == 3
    assert batcher.mean_batch_size(since=snap) == 1.0


def test_batcher_flush_drains_tail(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(4,), device="cpu")
    batcher = MicroBatcher(engine, max_batch=4, max_wait_us=1e9)
    h = batcher.submit(np.zeros((8, 1), np.float32))
    assert not h.done()
    with pytest.raises(RuntimeError, match="not served"):
        h.result()
    assert batcher.flush() == 1
    assert h.done() and h.ok() and h.latency_s >= 0.0
    assert batcher.flush() == 0


def test_batcher_packs_fifo_and_splits_oversize_queue(artifact_dir):
    engine = ServeEngine(artifact_dir, buckets=(4,), device="cpu")
    batcher = MicroBatcher(engine, max_batch=4, max_wait_us=1e9)
    x = _x(8, 3, 8)
    h3 = batcher.submit(x)
    h2 = batcher.submit(x[:, :2])
    assert h3.done() and h2.done()
    assert batcher.stats["batches"] == 2
    ref = engine.forward(x)
    assert torch.equal(h3.result(), ref)
    assert torch.equal(h2.result(), ref[:, :2])


@pytest.mark.parametrize(
    "method,status", [("_fail", "failed"), ("_reject", "rejected"), ("_expire", "expired")]
)
def test_pending_result_failure_states_raise_request_error(method, status):
    h = PendingResult(2, now=10.0)
    getattr(h, method)("why", now=10.5)
    assert h.done() and not h.ok() and h.status == status
    assert h.latency_s == 0.5
    with pytest.raises(RequestError, match=f"request {status}: why") as err:
        h.result()
    assert (err.value.status, err.value.reason) == (status, "why")
    with pytest.raises(RuntimeError, match="already terminal"):
        h._complete(None)


def test_size_bucket_and_pack_fifo_match_reference():
    from repro.serve.batcher import pack_fifo as j_pack
    from repro.serve.batcher import size_bucket as j_bucket

    for n in (0, 1, 2, 3, 5, 8, 9, 127, 128, 129):
        assert size_bucket(n) == j_bucket(n)
    sizes = [3, 1, 4, 1, 5, 9, 2, 6]
    t_queue = [(torch.zeros(2, j), j) for j in sizes]
    j_queue = [(np.zeros((2, j)), j) for j in sizes]
    t_batches = [[tag for _, tag in b] for b in pack_fifo(t_queue, 6)]
    j_batches = [[tag for _, tag in b] for b in j_pack(j_queue, 6)]
    assert t_batches == j_batches
    assert pack_fifo([], 4) == []


def test_batcher_rejects_bad_config(artifact_dir):
    engine = ServeEngine(artifact_dir, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(engine, max_batch=0)
    with pytest.raises(ValueError, match="max_wait_us"):
        MicroBatcher(engine, max_wait_us=-1.0)


# ---------------------------------------------------------------------------
# Feature specs
# ---------------------------------------------------------------------------


def test_feature_spec_grammar_matches_reference():
    from repro.serve import parse_features as j_parse

    for spec in (None, "identity", "rff:64:3", "relu:32", "relu:7:11"):
        t, j = parse_features(spec), j_parse(spec)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.kind, t.dim, t.seed, t.describe()) == (j.kind, j.dim, j.seed, j.describe())
    for bad in ("rff", "rff:", "rff:0", "rff:8:1:2", "fourier:8", "relu:x"):
        with pytest.raises(ValueError):
            parse_features(bad)


#: The normal draws behind W agree with jax's to a few f32 ulps
#: (``tests/test_torch_prng.py``); 4 ulps of |W|'s largest element.
FEATURE_ULPS = 4 * 2.0**-23


@pytest.mark.parametrize("spec", ["rff:8:1", "relu:8"])
def test_random_feature_extractors_wait_for_the_prng(artifact_dir, tmp_path, spec):
    """rff/relu weights come from jax.random, which the port's threefry
    PRNG now reproduces: the extractor draws repro's weights (b bit for
    bit, W to a few ulps), and a repro-exported artifact recording the
    extractor serves repro's logits within 1e-5."""
    from repro.serve import parse_features as j_parse

    got, want = parse_features(spec).materialize(8), j_parse(spec).materialize(8)
    assert len(got.params) == len(want.params)
    w, jw = got.params[0].numpy(), np.asarray(want.params[0])
    assert w.shape == jw.shape == (8, 8)
    assert np.abs(w - jw).max() <= FEATURE_ULPS * np.abs(jw).max()
    if spec.startswith("rff"):
        assert np.array_equal(got.params[1].numpy(), np.asarray(want.params[1]))
    x = _x(8, 5, 3)
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), np.asarray(want(jnp.asarray(x))),
                               **TOL)
    path = str(tmp_path / "feat")
    o, r = _np_stack(8, 3, 20, 2)
    j_export(path, _jparams(o, r), features=spec)
    assert load_artifact(path).features == spec
    engine = ServeEngine(path, buckets=(4, 16), device="cpu")
    assert engine.request_dim is None
    x = _x(8, 11, 4)
    ref = np.asarray(JServeEngine(path, buckets=(4, 16)).forward(x))
    np.testing.assert_allclose(engine.forward(x).numpy(), ref, **TOL)
    assert engine.request_dim == 8
    np.testing.assert_allclose(engine.forward(x[:, :3]).numpy(), ref[:, :3], **TOL)
