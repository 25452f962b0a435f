"""Checkpoints across the packages: a file written by ``repro`` resumes
in ``repro_torch`` and the other way round, and both serve through
``export_from_checkpoint``.

Geometry: ``tests/test_checkpoint.py``'s (M=4 workers of 16 samples,
P=8, Q=3, 3 layers of 20, K=20), with ``repro``'s data and R carried
across as numpy arrays (``convert.r_from_numpy``) and its key
``PRNGKey(7)`` passed to both.

Tolerances: readouts within 1e-4 relative (Frobenius) of ``repro``'s
uninterrupted run.  The layers a checkpoint carries are the writer's bit
for bit; each layer solved after the resume runs K f32 ADMM iterations
from Grams the packages sum in different orders (measured gaps below
2e-6 here, as in ``tests/test_torch_train.py``).  R redrawn from a key
(a rollback, or a checkpoint without r/*) is within 3 f32 ulps of
``repro``'s (``prng.normal``'s bar).  Schemas, keys and counts equal.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro import dssfn as jdssfn
from repro.checkpoint import store as jstore
from repro.core import layerwise as jlayerwise
from repro.core import ssfn as jssfn
from repro.serve import export_from_checkpoint as j_export_from_checkpoint
from repro.serve import load_artifact as j_load
from repro_torch import dssfn, prng
from repro_torch.convert import r_from_numpy
from repro_torch.core import layerwise, ssfn
from repro_torch.launch import train_dssfn
from repro_torch.serve import export_from_checkpoint, load_artifact

GEOM = dict(input_dim=8, num_classes=3, num_layers=3, hidden=20, admm_iters=20)
GAP = 1e-4
SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ref():
    """repro's data, R and uninterrupted run, and the same inputs as the
    port's tensors."""
    kx, kt = jax.random.split(jax.random.PRNGKey(3))
    xw = jax.random.normal(kx, (4, 8, 16))
    labels = jax.random.randint(kt, (4, 16), 0, 3)
    tw = jax.nn.one_hot(labels, 3).transpose(0, 2, 1)
    jkey = jax.random.PRNGKey(7)
    jcfg = jssfn.SSFNConfig(**GEOM)
    r = [np.asarray(a) for a in jssfn.init_random_matrices(jkey, jcfg)]
    full = jdssfn.train(jdssfn.TrainSpec(cfg=jcfg, workers=4), xw, tw, jkey)
    return dict(xw=xw, tw=tw, jkey=jkey, jcfg=jcfg, full=full,
                txw=torch.from_numpy(np.array(xw)), ttw=torch.from_numpy(np.array(tw)),
                r=r_from_numpy(r, device="cpu"), key=prng.PRNGKey(7))


def _jtrain(ref, **kw):
    spec = jdssfn.TrainSpec(cfg=ref["jcfg"], workers=4, **kw)
    return jdssfn.train(spec, ref["xw"], ref["tw"], ref["jkey"])


def _ttrain(ref, *, r=True, **kw):
    spec = dssfn.TrainSpec(cfg=ssfn.SSFNConfig(**GEOM), workers=4, **kw)
    return dssfn.train(spec, ref["txw"], ref["ttw"], r=ref["r"] if r else None, key=ref["key"])


def _assert_near_reference(res, ref):
    want = ref["full"]
    assert len(res.params.o) == len(want.params.o) == 4
    for l, (a, b) in enumerate(zip(res.params.o, want.params.o)):
        assert _rel(np.asarray(a), b) <= GAP, l
    assert res.log.comm_scalars == want.log.comm_scalars
    np.testing.assert_allclose(res.log.layer_costs, want.log.layer_costs, rtol=GAP)


def test_repro_checkpoint_resumes_in_port(ref, tmp_path):
    ck = str(tmp_path / "ck")
    _jtrain(ref, checkpoint_dir=ck, stop_after_layer=1)
    res = _ttrain(ref, checkpoint_dir=ck, resume=True)
    _assert_near_reference(res, ref)
    flat = jstore.load_pytree_flat(layerwise.checkpoint_path(ck, 2))
    for i in range(2):      # the carried layers are repro's, bit for bit
        assert np.array_equal(res.params.o[i].numpy(), flat[f"o/{i}"])
    assert all(np.array_equal(r.numpy(), flat[f"r/{i}"]) for i, r in enumerate(res.params.r))
    # Its checkpoints after the resume are the port's, still one run.
    assert layerwise.latest_checkpoint(ck) == layerwise.checkpoint_path(ck, 4)


def test_port_checkpoint_resumes_in_repro(ref, tmp_path):
    ck = str(tmp_path / "ck")
    first = _ttrain(ref, checkpoint_dir=ck, stop_after_layer=1)
    res = _jtrain(ref, checkpoint_dir=ck, resume=True)
    _assert_near_reference(res, ref)
    for a, b in zip(first.params.o, res.params.o):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _schema(path):
    return {k: (v.dtype.name, v.shape) for k, v in jstore.load_pytree_flat(path).items()}


def test_checkpoint_schema_equals_reference_leaf_for_leaf(ref, tmp_path):
    """Flat keys, dtypes and shapes, under the divergence guard (prev_cost
    set) and with size estimation off, at every saved depth."""
    for kw in (dict(), dict(guard_divergence=True)):
        jck, tck = str(tmp_path / "j"), str(tmp_path / "t")
        _jtrain(ref, checkpoint_dir=jck, **kw)
        _ttrain(ref, checkpoint_dir=tck, **kw)
        for ln in range(1, 5):
            want = _schema(layerwise.checkpoint_path(jck, ln))
            assert _schema(layerwise.checkpoint_path(tck, ln)) == want, ln
        assert want["key"] == ("uint32", (2,)) and want["layer_next"] == ("int64", ())
        assert want["jit"] == ("int32", (4, 4)) and want["membership"] == ("float64", (4,))
        assert want["prev_cost"] == ("float64", ()) and want["tr/obj"] == ("float32", (4, 20))
        j = jstore.load_pytree_flat(layerwise.checkpoint_path(jck, 4))
        t = jstore.load_pytree_flat(layerwise.checkpoint_path(tck, 4))
        for k in ("layer_next", "key", "comm", "jit", "membership"):
            assert np.array_equal(j[k], t[k]), k
        assert np.isnan(j["prev_cost"]) == np.isnan(t["prev_cost"])
        if kw:
            np.testing.assert_allclose(t["prev_cost"], j["prev_cost"], rtol=GAP)
        with open(layerwise.checkpoint_path(jck, 4) + ".meta.json") as f:
            jmeta = f.read()
        with open(layerwise.checkpoint_path(tck, 4) + ".meta.json") as f:
            assert f.read() == jmeta
        for d in (jck, tck):
            for name in os.listdir(d):
                os.remove(os.path.join(d, name))


def _strip_to_legacy(src, dst):
    """repro's checkpoint as the older schema wrote it: no r/* and no jit."""
    flat = jstore.load_pytree_flat(src)
    jstore.save_pytree(dst, {k: v for k, v in flat.items()
                             if not k.startswith("r/") and k != "jit"})


@pytest.mark.parametrize("reader", ["port", "repro"])
def test_legacy_checkpoint_resumes_in_both(ref, tmp_path, reader):
    """Without r/* the reader redraws R from the stored key: repro's R
    exactly in repro, within 3 ulps in the port; the jitter history
    restarts with the resumed layers."""
    jck, old = str(tmp_path / "j"), str(tmp_path / "old")
    _jtrain(ref, checkpoint_dir=jck, stop_after_layer=1)
    os.makedirs(old)
    _strip_to_legacy(layerwise.checkpoint_path(jck, 2), layerwise.checkpoint_path(old, 2))
    if reader == "port":
        res = _ttrain(ref, r=False, checkpoint_dir=old, resume=True)
        want = ref["full"].params.r
        for a, b in zip(res.params.r, want):
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=3)
    else:
        res = _jtrain(ref, checkpoint_dir=old, resume=True)
    _assert_near_reference(res, ref)
    assert np.asarray(res.log.jitter_levels).shape == (2, 4)


def test_forced_rollback_redraws_reference_r(ref, tmp_path, monkeypatch):
    """Both packages flag layer 2's first attempt with checkpoints every
    layer: each rolls back to layer 2 and redraws R_2, R_3 from
    fold_in(key, 8), the port within 3 ulps of repro; the healed runs'
    readouts agree to the readout bar."""
    def flag_third(real):
        calls = {"n": 0}

        def fake(step, prev_cost, blowup=1e3):
            calls["n"] += 1
            return calls["n"] == 3 or real(step, prev_cost, blowup)
        return fake

    monkeypatch.setattr(jlayerwise, "_step_diverged", flag_third(jlayerwise._step_diverged))
    monkeypatch.setattr(layerwise, "_step_diverged", flag_third(layerwise._step_diverged))
    with pytest.warns(RuntimeWarning, match="rolling back to layer 2"):
        jres = _jtrain(ref, checkpoint_dir=str(tmp_path / "j"), guard_divergence=True)
    with pytest.warns(RuntimeWarning, match="rolling back to layer 2"):
        tres = _ttrain(ref, checkpoint_dir=str(tmp_path / "t"), guard_divergence=True)
    assert tres.log.rollbacks == jres.log.rollbacks == 1
    assert np.array_equal(tres.params.r[0].numpy(), np.asarray(ref["full"].params.r[0]))
    for a, b, clean in zip(tres.params.r[1:], jres.params.r[1:], ref["full"].params.r[1:]):
        np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=3)
        assert not np.array_equal(np.asarray(b), np.asarray(clean))
    for l, (a, b) in enumerate(zip(tres.params.o, jres.params.o)):
        assert _rel(a.numpy(), b) <= GAP, l


def test_export_from_reference_checkpoint_matches_reference_artifact(ref, tmp_path):
    ck = str(tmp_path / "ck")
    _jtrain(ref, checkpoint_dir=ck, checkpoint_every=2)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    export_from_checkpoint(ck, ours)
    j_export_from_checkpoint(ck, theirs)
    a, b = load_artifact(ours), j_load(theirs)
    assert a.num_layers == b.num_layers == 3
    assert a.manifest == b.manifest
    for x, y in zip(a.params.o + a.params.r, b.params.o + b.params.r):
        assert np.array_equal(x.numpy(), np.asarray(y))
    # And the reference loads the port's export of its checkpoint.
    c = j_load(ours)
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(c.params.o, b.params.o))


LAUNCH = ["--device", "cpu", "--workers", "4", "--layers", "3", "--hidden", "40",
          "--admm-iters", "20", "--train", "256", "--test", "64"]


@pytest.mark.parametrize("consensus", ["exact", "async:rounds=2:interval=2:drop=0.2:seed=5@hypercube"])
def test_launcher_stop_and_resume_equals_uninterrupted(tmp_path, consensus):
    """--stop-after-layer 1 in this process, then --resume in a fresh
    one: the exported stack and the run's counts equal the uninterrupted
    launcher run's, bit for bit; under the seeded fault model too (the
    fresh process memoized none of the first one's draws)."""
    flags = LAUNCH + ["--consensus", consensus]
    full = train_dssfn.main(flags + ["--export-artifact", str(tmp_path / "full")])["runs"][0]
    ck = str(tmp_path / "ck")
    part = train_dssfn.main(flags + ["--checkpoint-dir", ck, "--stop-after-layer", "1",
                                     "--export-artifact", str(tmp_path / "part")])
    assert part["export"]["num_layers"] == 1
    assert layerwise.latest_checkpoint(ck) == layerwise.checkpoint_path(ck, 2)
    out = str(tmp_path / "resumed.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_dssfn", *flags, "--checkpoint-dir", ck,
         "--resume", "--export-artifact", str(tmp_path / "resumed"), "--out", out],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    with open(out) as f:
        resumed = json.load(f)["runs"][0]
    a, b = load_artifact(str(tmp_path / "full")), load_artifact(str(tmp_path / "resumed"))
    assert len(a.params.o) == len(b.params.o) == 4
    assert all(torch.equal(x, y) for x, y in zip(a.params.o + a.params.r, b.params.o + b.params.r))
    for k in ("comm_scalars", "final_objective", "test_accuracy", "rollbacks", "policy"):
        assert resumed[k] == full[k], k
    assert resumed["consensus_error"] == full["consensus_error"]
