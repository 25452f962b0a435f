"""repro_torch.checkpoint.store against repro.checkpoint.store.

Files written by either package load in the other with bit-equal
leaves (f32, bf16, integer scalars), the sidecar records the same keys,
dtypes and shapes in the same order, and every corruption mode raises
CheckpointCorruptError, as the reference's PR-7 drills require.
"""
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "o": {str(i): rng.standard_normal((3, 8 + i)).astype(np.float32) for i in range(12)},
        "r": [rng.standard_normal((4, 5)).astype(np.float32)],
        "layer_next": np.int32(7),
    }


def _torch_tree(tree):
    return {
        "o": {k: torch.from_numpy(v) for k, v in tree["o"].items()},
        "r": [torch.from_numpy(v) for v in tree["r"]],
        "layer_next": torch.tensor(int(tree["layer_next"]), dtype=torch.int32),
    }


def _flat_numpy(tree):
    out = {f"o/{k}": v for k, v in tree["o"].items()}
    out["r/0"] = tree["r"][0]
    out["layer_next"] = np.asarray(tree["layer_next"])
    return out


def test_port_file_loads_in_repro_bit_exact(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck.npz")
    tstore.save_pytree(path, _torch_tree(tree))
    got = jstore.load_pytree_flat(path)
    want = _flat_numpy(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_repro_file_loads_in_port_bit_exact(tmp_path):
    tree = _tree(1)
    path = str(tmp_path / "ck.npz")
    jstore.save_pytree(path, {
        "o": {k: jnp.asarray(v) for k, v in tree["o"].items()},
        "r": [jnp.asarray(v) for v in tree["r"]],
        "layer_next": jnp.asarray(tree["layer_next"]),
    })
    got = tstore.load_pytree_flat(path)
    for k, v in _flat_numpy(tree).items():
        assert isinstance(got[k], torch.Tensor)
        assert np.array_equal(got[k].numpy(), v), k


def test_sidecars_match_key_for_key_in_order(tmp_path):
    """Both packages flatten in jax.tree_util order (sorted dict keys:
    "o/10" before "o/2") and record the same dtype/shape per leaf."""
    tree = _tree(2)
    tstore.save_pytree(str(tmp_path / "t.npz"), _torch_tree(tree))
    jstore.save_pytree(str(tmp_path / "j.npz"), {
        "o": {k: jnp.asarray(v) for k, v in tree["o"].items()},
        "r": [jnp.asarray(v) for v in tree["r"]],
        "layer_next": jnp.asarray(tree["layer_next"]),
    })
    with open(tmp_path / "t.npz.meta.json") as f:
        t_meta = json.load(f)
    with open(tmp_path / "j.npz.meta.json") as f:
        j_meta = json.load(f)
    assert list(t_meta.items()) == list(j_meta.items())
    assert list(np.load(tmp_path / "t.npz").files) == list(np.load(tmp_path / "j.npz").files)


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_bf16_round_trips_both_ways(writer, tmp_path):
    rng = np.random.default_rng(3)
    a32 = rng.standard_normal((4, 6)).astype(np.float32)
    a16 = a32.astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "bf.npz")
    if writer == "port":
        tstore.save_pytree(path, {"w": torch.from_numpy(a32).to(torch.bfloat16)})
    else:
        jstore.save_pytree(path, {"w": jnp.asarray(a16)})
    got_t = tstore.load_pytree_flat(path)["w"]
    got_j = jstore.load_pytree_flat(path)["w"]
    assert got_t.dtype == torch.bfloat16
    assert got_j.dtype == ml_dtypes.bfloat16
    # Both read the same bits, and they are a16's bits.
    assert np.array_equal(got_t.view(torch.int16).numpy().view(np.uint16), a16.view(np.uint16))
    assert np.array_equal(got_j.view(np.uint16), a16.view(np.uint16))


def test_sidecar_written_before_npz_and_no_stage_files(tmp_path):
    path = str(tmp_path / "ck.npz")
    tstore.save_pytree(path, _torch_tree(_tree()))
    assert sorted(os.listdir(tmp_path)) == ["ck.npz", "ck.npz.meta.json"]
    assert os.stat(path + ".meta.json").st_mtime_ns <= os.stat(path).st_mtime_ns


def test_atomic_write_failure_keeps_previous_file(tmp_path):
    path = str(tmp_path / "f.bin")
    tstore._atomic_write(path, lambda f: f.write(b"old"))

    def boom(f):
        f.write(b"partial")
        raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        tstore._atomic_write(path, boom)
    assert open(path, "rb").read() == b"old"
    assert os.listdir(tmp_path) == ["f.bin"]


# ---------------------------------------------------------------------------
# Corruption drills (mirrors tests/test_checkpoint.py's PR-7 cases)
# ---------------------------------------------------------------------------


@pytest.fixture
def saved(tmp_path):
    path = str(tmp_path / "ck.npz")
    tstore.save_pytree(path, _torch_tree(_tree()))
    return path


def test_valid_checkpoint_is_valid(saved):
    assert tstore.is_valid_checkpoint(saved)
    assert tstore.is_valid_checkpoint(saved.removesuffix(".npz"))


def test_missing_file_is_corrupt(tmp_path):
    assert not tstore.is_valid_checkpoint(str(tmp_path / "nope.npz"))
    with pytest.raises(tstore.CheckpointCorruptError, match="does not exist"):
        tstore.load_pytree_flat(str(tmp_path / "nope.npz"))


def test_missing_sidecar_is_corrupt(saved):
    os.remove(saved + ".meta.json")
    with pytest.raises(tstore.CheckpointCorruptError, match="sidecar"):
        tstore.load_pytree_flat(saved)


def test_garbage_sidecar_is_corrupt(saved):
    with open(saved + ".meta.json", "w") as f:
        f.write("{not json")
    with pytest.raises(tstore.CheckpointCorruptError, match="unreadable metadata"):
        tstore.load_pytree_flat(saved)


def test_truncated_npz_is_corrupt(saved):
    blob = open(saved, "rb").read()
    with open(saved, "wb") as f:
        f.write(blob[: len(blob) // 2])
    assert not tstore.is_valid_checkpoint(saved)
    with pytest.raises(tstore.CheckpointCorruptError):
        tstore.load_pytree_flat(saved)


def test_missing_expected_key_is_corrupt(saved):
    with pytest.raises(tstore.CheckpointCorruptError, match="missing required"):
        tstore.load_pytree_flat(saved, expect_keys=["o/0", "o/99"])


def test_shape_mismatch_is_corrupt(saved):
    with open(saved + ".meta.json") as f:
        meta = json.load(f)
    meta["o/0"]["shape"] = [9, 9]
    with open(saved + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(tstore.CheckpointCorruptError, match="shape"):
        tstore.load_pytree_flat(saved)


# ---------------------------------------------------------------------------
# load_pytree(like=): a template's structure, dtypes and devices
# ---------------------------------------------------------------------------

def test_load_pytree_round_trips_nested_dicts_and_lists(tmp_path):
    """Nested dicts, lists and tuples come back in the template's
    structure, each leaf in its template leaf's dtype: int64 and uint32
    scalars and keys, f64 and f32 tensors, numpy leaves as numpy."""
    rng = np.random.default_rng(4)
    state = {
        "duals": [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
                  for _ in range(2)],
        "stale": (torch.zeros((2, 3, 5), dtype=torch.float64), torch.tensor(1, dtype=torch.int32)),
        "key": np.array([0, 7], np.uint32),
        "comm": np.int64(123456789),
        "nested": {"b": {"c": torch.arange(4, dtype=torch.int64)}, "a": [np.float64(1 / 3)]},
    }
    path = str(tmp_path / "tpl.npz")
    tstore.save_pytree(path, state)
    back = tstore.load_pytree(path, state)
    assert isinstance(back["duals"], list) and isinstance(back["stale"], tuple)
    assert list(back) == list(state) and list(back["nested"]) == ["b", "a"]
    for a, b in zip(state["duals"], back["duals"]):
        assert b.dtype == torch.float32 and torch.equal(a, b)
    assert back["stale"][0].dtype == torch.float64 and torch.equal(back["stale"][1], state["stale"][1])
    assert back["key"].dtype == np.uint32 and np.array_equal(back["key"], state["key"])
    assert back["comm"].dtype == np.int64 and back["comm"] == state["comm"]
    assert torch.equal(back["nested"]["b"]["c"], state["nested"]["b"]["c"])
    assert back["nested"]["a"][0] == state["nested"]["a"][0]
    # A template leaf's dtype wins over the file's; a missing leaf raises.
    cast = tstore.load_pytree(path, {"duals": [torch.zeros(1, dtype=torch.float64)] * 2})
    assert cast["duals"][1].dtype == torch.float64
    assert torch.equal(cast["duals"][1], state["duals"][1].double())
    with pytest.raises(tstore.CheckpointCorruptError, match="missing required"):
        tstore.load_pytree(path, {"absent": torch.zeros(1)})


def test_load_pytree_restores_bf16_templates(tmp_path):
    a16 = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32))
    a16 = a16.to(torch.bfloat16)
    path = str(tmp_path / "bf.npz")
    tstore.save_pytree(path, {"w": a16, "s": [a16[0]]})
    back = tstore.load_pytree(path, {"w": torch.zeros(1, dtype=torch.bfloat16),
                                     "s": [torch.zeros(1, dtype=torch.bfloat16)]})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), a16.view(torch.int16))
    assert torch.equal(back["s"][0].view(torch.int16), a16[0].view(torch.int16))


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_load_pytree_reads_the_other_package_bit_for_bit(writer, tmp_path):
    """A file written by one package loads into the other's template: the
    port's tensors from repro's file, repro's arrays from the port's."""
    tree = _tree(6)
    a16 = tree["o"]["0"].astype(ml_dtypes.bfloat16)
    path = str(tmp_path / "x.npz")
    jtree = {"o": {k: jnp.asarray(v) for k, v in tree["o"].items()},
             "r": [jnp.asarray(v) for v in tree["r"]],
             "layer_next": jnp.asarray(tree["layer_next"]), "bf": jnp.asarray(a16)}
    ttree = dict(_torch_tree(tree), bf=torch.from_numpy(tree["o"]["0"]).to(torch.bfloat16))
    if writer == "repro":
        jstore.save_pytree(path, jtree)
        back = tstore.load_pytree(path, ttree)
        got = {k: v.view(torch.int16).numpy().view(np.uint16) if v.dtype == torch.bfloat16
               else v.numpy() for k, v in tstore._flatten_with_paths(back).items()}
    else:
        tstore.save_pytree(path, ttree)
        back = jstore.load_pytree(path, jtree)
        got = {k: np.asarray(v) for k, v in tstore._flatten_with_paths(back).items()}
        got["bf"] = got["bf"].view(np.uint16)
    want = dict(_flat_numpy(tree), bf=a16.view(np.uint16))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
