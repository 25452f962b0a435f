"""npz checkpoints of nested dicts of tensors, in ``repro``'s on-disk format.

A checkpoint is ``<name>.npz`` holding one array per leaf under its tree
path (``"o/0"``, ``"r/3"``) plus ``<name>.npz.meta.json`` recording each
leaf's dtype and shape; bf16 leaves are stored as their uint16 bits and
tagged ``"bfloat16"`` in the sidecar.  Files written here load in
``repro.checkpoint.store`` and the other way round.

Crash-safety contract (the same as ``repro``'s):

- :func:`save_pytree` stages both files as temp files in the target
  directory, fsyncs them and publishes them with ``os.replace``, sidecar
  first and npz last, so a complete npz at its final name implies its
  sidecar is complete too.
- :func:`load_pytree_flat` re-raises every corruption mode as
  :class:`CheckpointCorruptError` naming the file and the defect.

:func:`load_pytree` restores a file into a template's structure, dtypes
and devices; :func:`load_pytree_flat` needs no template (elastic resume
rebuilds its state from the flat mapping).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Iterable

import numpy as np
import torch


class CheckpointCorruptError(Exception):
    """A checkpoint file is unreadable or structurally wrong."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"corrupt checkpoint {path!r}: {detail}")


def _flatten_with_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """``{"a/b/0": leaf}`` in ``jax.tree_util`` order: dict keys sorted,
    list and tuple items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten_with_paths(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _meta_path(npz_path: str) -> str:
    return npz_path + ".meta.json"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_write(final_path: str, write_fn) -> None:
    """Stage via mkstemp in the destination directory, fsync, publish
    with ``os.replace`` (atomic on POSIX within one filesystem)."""
    directory = os.path.dirname(final_path) or "."
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(final_path) + ".tmp."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """Host copy of a leaf and the dtype name the sidecar records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no bf16: store the bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_pytree(path: str, tree: Any) -> None:
    """Write a nested dict/list of tensors (or arrays, or scalars)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        a, dtype = _to_numpy(v)
        meta[k] = {"dtype": dtype, "shape": list(a.shape)}
        arrays[k] = a
    npz_path = _npz_path(path)
    # Sidecar first, npz last: the npz appearing at its final name is
    # the commit point, and it implies the sidecar is already in place.
    _atomic_write(
        _meta_path(npz_path), lambda f: f.write(json.dumps(meta).encode())
    )
    _atomic_write(npz_path, lambda f: np.savez(f, **arrays))


def load_pytree_flat(
    path: str, *, expect_keys: Iterable[str] | None = None
) -> dict[str, torch.Tensor]:
    """The flat ``{tree-path: tensor}`` mapping :func:`save_pytree` (or
    ``repro``'s) wrote, as CPU tensors, bf16 leaves rebuilt from the
    sidecar.

    Raises :class:`CheckpointCorruptError` for an unreadable or truncated
    npz, a missing or unreadable sidecar, keys in ``expect_keys`` absent
    from the archive, and arrays whose shape disagrees with the sidecar.
    """
    npz_path = _npz_path(path)
    if not os.path.exists(npz_path):
        raise CheckpointCorruptError(npz_path, "file does not exist")
    meta_path = _meta_path(npz_path)
    if not os.path.exists(meta_path):  # save_pytree("x") -> x.meta.json
        legacy = npz_path.removesuffix(".npz") + ".meta.json"
        if os.path.exists(legacy):
            meta_path = legacy
        else:
            raise CheckpointCorruptError(
                npz_path, f"metadata sidecar {meta_path!r} is missing"
            )
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            npz_path, f"unreadable metadata sidecar {meta_path!r} ({e})"
        ) from e
    try:
        data = np.load(npz_path)
    except Exception as e:  # zipfile.BadZipFile, OSError, pickle errors
        raise CheckpointCorruptError(
            npz_path, f"unreadable npz archive ({e})"
        ) from e
    out = {}
    try:
        names = set(data.files)
        if expect_keys is not None:
            missing = sorted(set(expect_keys) - names)
            if missing:
                raise CheckpointCorruptError(
                    npz_path, f"missing required key(s) {missing}"
                )
        for key in data.files:
            try:
                arr = data[key]
            except Exception as e:  # truncated member, bad CRC
                raise CheckpointCorruptError(
                    npz_path, f"unreadable array {key!r} ({e})"
                ) from e
            rec = meta.get(key, {})
            if "shape" in rec and list(arr.shape) != list(rec["shape"]):
                raise CheckpointCorruptError(
                    npz_path,
                    f"array {key!r} has shape {list(arr.shape)}, "
                    f"metadata records {rec['shape']}",
                )
            t = torch.from_numpy(np.asarray(arr, order="C"))
            if rec.get("dtype") == "bfloat16":
                t = t.view(torch.bfloat16)
            out[key] = t
    finally:
        data.close()
    return out


def is_valid_checkpoint(path: str) -> bool:
    """True iff the checkpoint loads end-to-end (resume-scan predicate)."""
    try:
        load_pytree_flat(path)
    except CheckpointCorruptError:
        return False
    return True


def _restore_like(like: Any, prefix: str, flat: dict[str, torch.Tensor]) -> Any:
    """``like``'s structure with each leaf replaced by ``flat``'s leaf at
    the same tree path, in the template leaf's dtype (and device, for a
    tensor)."""
    def child(key: str) -> str:
        return f"{prefix}/{key}" if prefix else key

    if isinstance(like, dict):
        return type(like)(
            (k, _restore_like(v, child(str(k)), flat)) for k, v in like.items()
        )
    if isinstance(like, (list, tuple)):
        items = [_restore_like(v, child(str(i)), flat) for i, v in enumerate(like)]
        return type(like)(*items) if hasattr(like, "_fields") else type(like)(items)
    leaf = flat[prefix]
    if isinstance(like, torch.Tensor):
        return leaf.to(device=like.device, dtype=like.dtype)
    return np.asarray(leaf.numpy(), dtype=np.asarray(like).dtype)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a checkpoint into ``like``'s structure (nested dicts, lists
    and tuples): each leaf comes back in the dtype of ``like``'s leaf at
    the same tree path, a tensor leaf also on its device, a numpy or
    scalar leaf as a numpy array.  bf16 leaves come back from their uint16
    bits.  Raises :class:`CheckpointCorruptError` where the file is bad or
    lacks a leaf of ``like``."""
    flat = load_pytree_flat(path, expect_keys=_flatten_with_paths(like))
    return _restore_like(like, "", flat)
