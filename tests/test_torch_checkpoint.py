"""repro_torch's elastic training: checkpoints, resume, stop_after_layer
and the divergence guard, as ``tests/test_checkpoint.py`` holds
``repro``'s, plus ``serve.export_from_checkpoint``
(``tests/test_serve.py``'s two cases).

Each case is the reference's, run on the port on the CPU at the
reference's geometry (M=4 workers of 16 samples, P=8, Q=3, 3 layers of
20, K=20): a resumed run equals the uninterrupted one bit for bit, under
ExactMean and under a seeded fault model; a rollback restores completed
layers verbatim and redraws the rest from ``prng.fold_in(key, 7 +
rollbacks)``.  The data is numpy's from a seed; the cross-package cases
(checkpoints written by one package and resumed by the other) are in
``tests/test_torch_resume.py``.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import dssfn, prng
from repro_torch.checkpoint.store import (
    CheckpointCorruptError,
    is_valid_checkpoint,
    load_pytree_flat,
    save_pytree,
)
from repro_torch.core import layerwise, ssfn
from repro_torch.core.layerwise import checkpoint_path, latest_checkpoint
from repro_torch.core.policy import AsyncGossip, FaultModel
from repro_torch.core.topology import Hypercube, Masked, Membership, Ring
from repro_torch.serve import ArtifactCorruptError, export_from_checkpoint, load_artifact

KEY = prng.PRNGKey(7)


def _data(seed, m=4, p=8, q=3, jm=16):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((m, p, jm)).astype(np.float32)
    labels = rng.integers(0, q, (m, jm))
    tw = np.eye(q, dtype=np.float32)[labels].transpose(0, 2, 1)
    return torch.from_numpy(xw), torch.from_numpy(np.ascontiguousarray(tw))


def _cfg(**kw):
    defaults = dict(input_dim=8, num_classes=3, num_layers=3, hidden=20, admm_iters=20)
    defaults.update(kw)
    return ssfn.SSFNConfig(**defaults)


def _train(xw, tw, key=KEY, **spec):
    spec.setdefault("cfg", _cfg())
    spec.setdefault("workers", xw.shape[0])
    return dssfn.train(dssfn.TrainSpec(**spec), xw, tw, key=key)


def _layer_nexts(directory):
    return sorted(
        int(n.removeprefix("dssfn_layer_").removesuffix(".npz"))
        for n in os.listdir(directory) if n.endswith(".npz")
    )


def test_latest_checkpoint_selects_highest_layer(tmp_path):
    d = str(tmp_path)
    assert latest_checkpoint(d) is None
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    for ln in (1, 3, 2):
        save_pytree(checkpoint_path(d, ln), {"layer_next": np.int64(ln)})
    picked = latest_checkpoint(d)
    assert picked == checkpoint_path(d, 3) == os.path.join(d, "dssfn_layer_003.npz")
    assert int(load_pytree_flat(picked)["layer_next"]) == 3


# ---------------------------------------------------------------------------
# Kill/resume drills: resumed == uninterrupted, bit for bit
# ---------------------------------------------------------------------------

def _assert_same_run(res_a, res_b):
    assert len(res_a.params.o) == len(res_b.params.o)
    for a, b in zip(res_a.params.o, res_b.params.o):
        assert torch.equal(a, b)
    assert len(res_a.params.r) == len(res_b.params.r)
    for a, b in zip(res_a.params.r, res_b.params.r):
        assert torch.equal(a, b)
    assert res_a.log.comm_scalars == res_b.log.comm_scalars
    assert np.array_equal(res_a.log.admm_objective, res_b.log.admm_objective)
    assert np.array_equal(res_a.log.consensus_error, res_b.log.consensus_error)
    assert np.array_equal(res_a.log.jitter_levels, res_b.log.jitter_levels)
    np.testing.assert_allclose(res_a.log.layer_costs, res_b.log.layer_costs)


def _async_faulty():
    """A fresh policy object per train: a resume replays the fault draws
    from the absolute iteration, not from anything the first process
    memoized on its policy."""
    return AsyncGossip(rounds=2, topology=Hypercube(), interval=2,
                       faults=FaultModel(drop=0.2, seed=5))


@pytest.mark.parametrize("policy", [lambda: None, _async_faulty], ids=["exact", "async-faulty"])
def test_resume_matches_uninterrupted_run(tmp_path, policy):
    xw, tw = _data(3)
    full = _train(xw, tw, policy=policy())
    ckpt = str(tmp_path / "ckpt")
    first = _train(xw, tw, policy=policy(), checkpoint_dir=ckpt, stop_after_layer=1)
    assert len(first.params.o) == 2  # O_0, O_1: the partial model
    assert latest_checkpoint(ckpt) == checkpoint_path(ckpt, 2)
    resumed = _train(xw, tw, policy=policy(), checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, resumed)


def test_resume_matches_with_membership_mask(tmp_path):
    """Elastic membership rides the checkpoint: a masked-topology run
    resumes bit-exactly and the stored mask matches the active set."""
    xw, tw = _data(4, m=8)
    base = dict(cfg=_cfg(num_layers=2), policy=AsyncGossip(rounds=2, topology=Ring(2)),
                membership="11011111")
    key = prng.PRNGKey(9)
    full = _train(xw, tw, key, **base)
    ckpt = str(tmp_path / "ckpt")
    _train(xw, tw, key, **base, checkpoint_dir=ckpt, stop_after_layer=0)
    flat = load_pytree_flat(latest_checkpoint(ckpt))
    assert flat["membership"].dtype == torch.float64
    assert np.array_equal(flat["membership"].numpy(), np.array([1, 1, 0, 1, 1, 1, 1, 1.0]))
    resumed = _train(xw, tw, key, **base, checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, resumed)
    assert isinstance(resumed.policy.topology, Masked)
    assert resumed.policy.topology.membership == Membership(
        (True, True, False, True, True, True, True, True)
    )


def test_checkpoint_every_stride(tmp_path):
    xw, tw = _data(5)
    ckpt = str(tmp_path / "ckpt")
    _train(xw, tw, prng.PRNGKey(6), cfg=_cfg(num_layers=4), checkpoint_dir=ckpt,
           checkpoint_every=2)
    # Layers 0..4 completed -> layer_next in {2, 4} only (every 2nd).
    assert _layer_nexts(ckpt) == [2, 4]


def test_resume_with_empty_directory_trains_from_scratch(tmp_path):
    xw, tw = _data(8)
    key = prng.PRNGKey(2)
    plain = _train(xw, tw, key, cfg=_cfg(num_layers=1))
    ckpt = str(tmp_path / "fresh")
    os.makedirs(ckpt)
    resumed = _train(xw, tw, key, cfg=_cfg(num_layers=1), checkpoint_dir=ckpt, resume=True)
    _assert_same_run(plain, resumed)


def test_untraced_run_resumes_bit_for_bit(tmp_path):
    """trace_every=0 keeps no traces: the checkpoint has no tr/*, and the
    resumed log carries the same empty traces."""
    xw, tw = _data(3)
    full = _train(xw, tw, trace_every=0)
    ckpt = str(tmp_path / "ckpt")
    _train(xw, tw, trace_every=0, checkpoint_dir=ckpt, stop_after_layer=1)
    assert not any(k.startswith("tr/") for k in load_pytree_flat(latest_checkpoint(ckpt)))
    resumed = _train(xw, tw, trace_every=0, checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, resumed)
    assert resumed.log.admm_objective.shape == (4, 0) and resumed.log.layer_costs == []


def test_resume_of_a_finished_run_returns_the_checkpoint(tmp_path):
    """A checkpoint past the last layer resumes into no solve at all: the
    readouts, R and the traces (restored as numpy) come back as saved."""
    xw, tw = _data(3)
    ckpt = str(tmp_path / "ckpt")
    full = _train(xw, tw, checkpoint_dir=ckpt)
    assert _layer_nexts(ckpt) == [1, 2, 3, 4]
    again = _train(xw, tw, checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, again)


# ---------------------------------------------------------------------------
# Corrupt checkpoints: CheckpointCorruptError, and resume skips them
# ---------------------------------------------------------------------------

def _truncate(path, keep=40):
    with open(path, "rb") as f:
        head = f.read(keep)
    with open(path, "wb") as f:
        f.write(head)


def test_load_pytree_flat_corruption_modes(tmp_path):
    path = str(tmp_path / "st.npz")
    with pytest.raises(CheckpointCorruptError, match="does not exist"):
        load_pytree_flat(path)
    save_pytree(path, {"a": np.arange(4.0), "b": np.int64(3)})
    assert is_valid_checkpoint(path)
    os.rename(path + ".meta.json", path + ".meta.json.bak")
    with pytest.raises(CheckpointCorruptError, match="sidecar"):
        load_pytree_flat(path)
    assert not is_valid_checkpoint(path)
    os.rename(path + ".meta.json.bak", path + ".meta.json")
    with open(path + ".meta.json", "r+") as f:
        f.write("{oops")
    with pytest.raises(CheckpointCorruptError, match="metadata sidecar"):
        load_pytree_flat(path)
    save_pytree(path, {"a": np.arange(4.0), "b": np.int64(3)})
    with pytest.raises(CheckpointCorruptError, match=r"missing required key\(s\).*\['c'\]"):
        load_pytree_flat(path, expect_keys=["a", "b", "c"])
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    meta["a"]["shape"] = [5]
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(CheckpointCorruptError, match="shape"):
        load_pytree_flat(path)
    save_pytree(path, {"a": np.arange(4.0), "b": np.int64(3)})
    _truncate(path)
    with pytest.raises(CheckpointCorruptError, match="npz archive"):
        load_pytree_flat(path)
    assert not is_valid_checkpoint(path)


def test_latest_checkpoint_skips_partial_with_warning(tmp_path):
    d = str(tmp_path)
    for ln in (1, 2, 3):
        save_pytree(checkpoint_path(d, ln), {"layer_next": np.int64(ln)})
    _truncate(checkpoint_path(d, 3))
    with pytest.warns(RuntimeWarning, match="partial/corrupt"):
        picked = latest_checkpoint(d)
    assert picked == checkpoint_path(d, 2)
    os.remove(checkpoint_path(d, 2) + ".meta.json")
    with pytest.warns(RuntimeWarning, match="partial/corrupt"):
        picked = latest_checkpoint(d)
    assert picked == checkpoint_path(d, 1)


def test_atomic_save_never_exposes_partial_state(tmp_path, monkeypatch):
    path = str(tmp_path / "st.npz")
    save_pytree(path, {"a": np.arange(3.0)})

    class Boom(RuntimeError):
        pass

    def exploding_savez(f, **arrays):
        f.write(b"partial bytes that must never be published")
        raise Boom("disk full")

    monkeypatch.setattr(np, "savez", exploding_savez)
    with pytest.raises(Boom):
        save_pytree(path, {"a": np.arange(3.0) + 1})
    monkeypatch.undo()
    assert is_valid_checkpoint(path)
    assert np.array_equal(load_pytree_flat(path)["a"].numpy(), np.arange(3.0))
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


def test_resume_recovers_from_kill_mid_save(tmp_path):
    """A truncated npz at layer 3's name plus an orphaned stage file:
    resume warns, falls back to layer 2's checkpoint and still equals the
    uninterrupted run bit for bit."""
    xw, tw = _data(3)
    full = _train(xw, tw)
    ckpt = str(tmp_path / "ckpt")
    _train(xw, tw, checkpoint_dir=ckpt, stop_after_layer=1)
    good = checkpoint_path(ckpt, 2)
    assert latest_checkpoint(ckpt) == good
    with open(good, "rb") as f:
        blob = f.read()
    deeper = checkpoint_path(ckpt, 3)
    with open(deeper, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with open(deeper + ".tmp.abc123", "wb") as f:
        f.write(b"orphaned stage file")
    with pytest.warns(RuntimeWarning, match="partial/corrupt"):
        resumed = _train(xw, tw, checkpoint_dir=ckpt, resume=True)
    _assert_same_run(full, resumed)


def test_checkpoint_roundtrips_random_matrices(tmp_path):
    """The checkpoint stores the whole R list in use (r/<i>), and the
    partial model's consumed prefix equals it verbatim."""
    xw, tw = _data(3)
    ckpt = str(tmp_path / "ckpt")
    res = _train(xw, tw, checkpoint_dir=ckpt, stop_after_layer=1)
    flat = load_pytree_flat(latest_checkpoint(ckpt))
    stored = 0
    while f"r/{stored}" in flat:
        stored += 1
    assert stored == _cfg().num_layers
    assert len(res.params.r) <= stored
    for i, r in enumerate(res.params.r):
        assert torch.equal(flat[f"r/{i}"], r)


def test_generator_run_checkpoints_the_launchers_key(tmp_path):
    """A generator run's key is PRNGKey(generator.initial_seed()), the key
    repro's launcher seeds with; the generator's R is what is stored."""
    xw, tw = _data(3)
    ckpt = str(tmp_path / "ckpt")
    gen = torch.Generator().manual_seed(8)
    spec = dssfn.TrainSpec(cfg=_cfg(), workers=4, checkpoint_dir=ckpt, stop_after_layer=0)
    dssfn.train(spec, xw, tw, gen)
    flat = load_pytree_flat(latest_checkpoint(ckpt))
    assert flat["key"].dtype == torch.uint32
    assert np.array_equal(flat["key"].numpy(), prng.PRNGKey(8))
    want = ssfn.init_random_matrices(_cfg(), generator=torch.Generator().manual_seed(8),
                                     device="cpu")
    assert all(torch.equal(flat[f"r/{i}"], r) for i, r in enumerate(want))


def test_resume_restores_in_cfg_dtype(tmp_path):
    """Restored state takes the run's dtype: an f32 checkpoint resumed
    under a float64 config continues in float64."""
    xw, tw = _data(3)
    ckpt = str(tmp_path / "ckpt")
    first = _train(xw, tw, checkpoint_dir=ckpt, stop_after_layer=1)
    cfg64 = _cfg(dtype=torch.float64)
    flat = load_pytree_flat(latest_checkpoint(ckpt))
    r64 = [flat[f"r/{i}"].double() for i in range(3)]
    res = dssfn.train(dssfn.TrainSpec(cfg=cfg64, workers=4, checkpoint_dir=ckpt, resume=True),
                      xw.double(), tw.double(), r=r64, key=KEY)
    assert all(o.dtype == torch.float64 for o in res.params.o)
    assert all(r.dtype == torch.float64 for r in res.params.r)
    assert torch.equal(res.params.o[0], first.params.o[0].double())


def test_checkpoints_and_the_guard_need_a_key(tmp_path):
    xw, tw = _data(3)
    r = ssfn.init_random_matrices(_cfg(), key=KEY, device="cpu")
    for kw in (dict(checkpoint_dir=str(tmp_path)), dict(guard_divergence=True)):
        with pytest.raises(ValueError, match="key"):
            layerwise.train_decentralized_ssfn(xw, tw, _cfg(), r=r, **kw)
    _, log = layerwise.train_decentralized_ssfn(xw, tw, _cfg(), r=r, key=KEY,
                                                checkpoint_dir=str(tmp_path))
    assert _layer_nexts(str(tmp_path)) == [1, 2, 3, 4] and log.rollbacks == 0


# ---------------------------------------------------------------------------
# Divergence guard: rollback, key perturbation, budget exhaustion
# ---------------------------------------------------------------------------

class _FakeStep:
    def __init__(self, o_star, objective=None):
        self.o_star = torch.as_tensor(np.asarray(o_star, np.float32))
        self.trace = None
        if objective is not None:
            class _Tr:
                pass
            self.trace = _Tr()
            self.trace.objective = torch.as_tensor(np.asarray(objective, np.float32))


def test_step_diverged_predicate():
    ok = _FakeStep(np.ones((3, 4)), objective=[2.0, 1.0])
    assert not layerwise._step_diverged(ok, prev_cost=1.5)
    assert layerwise._step_diverged(_FakeStep(np.array([1.0, np.nan])), prev_cost=None)
    assert layerwise._step_diverged(_FakeStep(np.ones(3), objective=[np.inf]), prev_cost=None)
    assert layerwise._step_diverged(_FakeStep(np.ones(3), objective=[5e3]), prev_cost=1.0)
    assert not layerwise._step_diverged(_FakeStep(np.ones(3), objective=[5e3]), prev_cost=None)
    assert layerwise._step_diverged(_FakeStep(np.array([np.inf]), objective=[1.0]), prev_cost=None)


def _flag_call(monkeypatch, which):
    """Make the monitor flag its ``which``-th call (1-based)."""
    real = layerwise._step_diverged
    calls = {"n": 0}

    def fake(step, prev_cost, blowup=1e3):
        calls["n"] += 1
        if calls["n"] == which:
            return True
        return real(step, prev_cost, blowup)

    monkeypatch.setattr(layerwise, "_step_diverged", fake)


def test_divergence_guard_rolls_back_with_perturbed_key(monkeypatch):
    """The first solve is flagged: with no checkpoint the run restarts
    from its entry state with every R redrawn from fold_in(key, 8)."""
    xw, tw = _data(3)
    clean = _train(xw, tw)
    _flag_call(monkeypatch, 1)
    with pytest.warns(RuntimeWarning, match="rolling back to layer 0"):
        healed = _train(xw, tw, guard_divergence=True)
    assert healed.log.rollbacks == 1
    assert len(healed.params.o) == len(clean.params.o)
    assert all(bool(torch.isfinite(o).all()) for o in healed.params.o)
    assert not torch.equal(healed.params.r[0], clean.params.r[0])
    want = ssfn.init_random_matrices(_cfg(), key=prng.fold_in(KEY, 8), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(healed.params.r, want))


def test_divergence_guard_restores_checkpointed_layers_verbatim(tmp_path, monkeypatch):
    xw, tw = _data(3)
    ckpt = str(tmp_path / "ckpt")
    base = dict(checkpoint_dir=ckpt, checkpoint_every=1)
    clean = _train(xw, tw, **base)
    shutil.rmtree(ckpt)
    # Layers 0 and 1 succeed (and checkpoint); layer 2's first attempt
    # "diverges".
    _flag_call(monkeypatch, 3)
    with pytest.warns(RuntimeWarning, match="rolling back to layer 2"):
        healed = _train(xw, tw, **base, guard_divergence=True)
    assert healed.log.rollbacks == 1
    for a, b in zip(clean.params.o[:2], healed.params.o[:2]):
        assert torch.equal(a, b)
    assert torch.equal(clean.params.r[0], healed.params.r[0])
    assert not torch.equal(clean.params.r[1], healed.params.r[1])
    want = ssfn.init_random_matrices(_cfg(), key=prng.fold_in(KEY, 8), device="cpu")
    assert torch.equal(healed.params.r[1], want[1])
    # The checkpoints written after the rollback carry the perturbed key.
    flat = load_pytree_flat(latest_checkpoint(ckpt))
    assert np.array_equal(flat["key"].numpy(), prng.fold_in(KEY, 8))


def test_divergence_guard_budget_exhaustion_raises(monkeypatch):
    xw, tw = _data(3)
    monkeypatch.setattr(layerwise, "_step_diverged", lambda step, prev_cost, blowup=1e3: True)
    with pytest.raises(RuntimeError, match="rollback budget"):
        _train(xw, tw, guard_divergence=True, max_rollbacks=0)


def test_checkpoint_validation_errors():
    xw, tw = _data(1)
    cfg = _cfg(num_layers=1)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, key=KEY, resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, key=KEY, checkpoint_dir="/tmp/x",
                                           checkpoint_every=0)
    with pytest.raises(ValueError, match="max_rollbacks"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, key=KEY, max_rollbacks=-1)
    with pytest.raises(ValueError, match="consensus_fn"):
        layerwise.train_decentralized_ssfn(xw, tw, cfg, key=KEY, consensus_fn=lambda z: z,
                                           checkpoint_dir="/tmp/x")


# ---------------------------------------------------------------------------
# serve.export_from_checkpoint
# ---------------------------------------------------------------------------

def test_export_from_checkpoint_matches_direct_export(tmp_path):
    xw, tw = _data(0)
    ck = str(tmp_path / "ckpt")
    result = _train(xw, tw, prng.PRNGKey(1), cfg=_cfg(num_layers=2, admm_iters=30),
                    checkpoint_dir=ck, checkpoint_every=1)
    path = str(tmp_path / "art")
    assert export_from_checkpoint(ck, path) == path
    art = load_artifact(path)
    assert art.manifest["source"] == os.path.abspath(checkpoint_path(ck, 3))
    for a, b in zip(art.params.o, result.params.o):
        assert torch.equal(a, b)
    for a, b in zip(art.params.r, result.params.r):
        assert torch.equal(a, b)
    # One file works too, and gives that file's depth.
    export_from_checkpoint(checkpoint_path(ck, 2), str(tmp_path / "art2"), features="rff:8")
    art2 = load_artifact(str(tmp_path / "art2"))
    assert art2.num_layers == 1 and art2.features == "rff:8"


def test_export_from_missing_checkpoint_raises(tmp_path):
    with pytest.raises(ArtifactCorruptError):
        export_from_checkpoint(str(tmp_path / "nope"), str(tmp_path / "art"))
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        export_from_checkpoint(str(tmp_path / "empty"), str(tmp_path / "art"))


def test_export_from_checkpoint_rejects_foreign_and_legacy_files(tmp_path):
    foreign = str(tmp_path / "foreign.npz")
    save_pytree(foreign, {"a": np.arange(3.0)})
    with pytest.raises(ArtifactCorruptError, match="no layer_next"):
        export_from_checkpoint(foreign, str(tmp_path / "art"))
    legacy = str(tmp_path / "legacy.npz")
    save_pytree(legacy, {"layer_next": np.int64(2),
                         "o": {"0": np.ones((3, 8), np.float32), "1": np.ones((3, 20), np.float32)}})
    with pytest.raises(ArtifactCorruptError, match=r"lacks weight entries \['r/0'\]"):
        export_from_checkpoint(legacy, str(tmp_path / "art"))
    assert not os.path.exists(tmp_path / "art")
