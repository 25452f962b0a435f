"""Serving artifacts in ``repro``'s format: write, load and validate.

An artifact is a directory

    artifact/
      weights.npz            flat {o/i, r/i} pytree (checkpoint.store)
      weights.npz.meta.json  dtype/shape sidecar (store's own format)
      manifest.json          version, dims, activation, feature spec

written through the checkpoint store's crash-safe writes, weights first
and manifest LAST, so a manifest at its final name is the commit point
and implies complete weights.  The format and version are ``repro``'s,
so an artifact exported by either package serves in the other.

:func:`export_artifact` takes an in-memory ``SSFNParams`` or a
``dssfn.TrainResult``; :func:`export_from_checkpoint` converts a training
checkpoint (either package's) without rebuilding a trainer.

:func:`load_artifact` re-raises every defect (truncated npz, missing
sidecar or manifest, schema drift, a weight-shape chain that cannot
assemble into an SSFN) as :class:`ArtifactCorruptError`;
:func:`is_valid_artifact` is the boolean predicate.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.checkpoint.store import (
    CheckpointCorruptError,
    _atomic_write,
    load_pytree_flat,
    save_pytree,
)
from repro_torch.core.ssfn import SSFNParams
from repro_torch.serve.features import parse_features

ARTIFACT_FORMAT = "dssfn-serve-artifact"
ARTIFACT_VERSION = 1
MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.npz"


class ArtifactCorruptError(Exception):
    """A serving artifact is unreadable, schema-mismatched, or its
    weight shapes cannot assemble into a valid SSFN stack."""

    def __init__(self, path: str, detail: str):
        self.path = path
        self.detail = detail
        super().__init__(f"corrupt artifact {path!r}: {detail}")


@dataclass(frozen=True)
class ServeArtifact:
    """A loaded, validated artifact: everything the engine needs.
    ``params`` are f32 tensors on the CPU."""

    params: SSFNParams
    num_classes: int
    input_dim: int
    activation: str                 # "relu" (the only v1 activation)
    features: str | None            # frozen extractor spec, or None
    version: int
    manifest: dict[str, Any]
    path: str | None = None

    @property
    def num_layers(self) -> int:
        """L: hidden layers (readouts minus the input readout O_0)."""
        return len(self.params.o) - 1

    def describe(self) -> str:
        feat = self.features or "identity"
        return (
            f"artifact(v{self.version}, P={self.input_dim}, "
            f"Q={self.num_classes}, L={self.num_layers}, "
            f"activation={self.activation}, features={feat})"
        )


def _validate_stack(o_list, r_list, *, path: str) -> tuple[int, int]:
    """The weight-shape chain check: (O_0..O_L, R_1..R_L) must assemble
    into W_{l+1} = [V_Q O_l ; R_{l+1}] with consistent dims.  Returns
    (num_classes, input_dim)."""
    if not o_list:
        raise ArtifactCorruptError(path, "no layer readouts (o/0 missing)")
    if len(r_list) != len(o_list) - 1:
        raise ArtifactCorruptError(
            path,
            f"{len(o_list)} readouts need {len(o_list) - 1} random "
            f"matrices, found {len(r_list)}",
        )
    if o_list[0].ndim != 2:
        raise ArtifactCorruptError(
            path, f"readout o/0 has shape {tuple(o_list[0].shape)}, expected 2-D"
        )
    q = int(o_list[0].shape[0])
    p = int(o_list[0].shape[1])
    for i, o in enumerate(o_list):
        if o.ndim != 2 or int(o.shape[0]) != q:
            raise ArtifactCorruptError(
                path,
                f"readout o/{i} has shape {tuple(o.shape)}, expected "
                f"({q}, *) — all readouts share Q rows",
            )
    width = p
    for i, r in enumerate(r_list):
        if r.ndim != 2 or int(r.shape[1]) != width:
            raise ArtifactCorruptError(
                path,
                f"random matrix r/{i} has shape {tuple(r.shape)}, "
                f"expected (*, {width}) to consume layer-{i} features",
            )
        width = 2 * q + int(r.shape[0])      # n_{i+1} = 2Q + rows(R)
        if int(o_list[i + 1].shape[1]) != width:
            raise ArtifactCorruptError(
                path,
                f"readout o/{i + 1} has shape "
                f"{tuple(o_list[i + 1].shape)}, expected ({q}, {width}) "
                f"to read layer-{i + 1} features",
            )
    return q, p


def _weight_keys(num_readouts: int) -> list[str]:
    keys = [f"o/{i}" for i in range(num_readouts)]
    keys += [f"r/{i}" for i in range(num_readouts - 1)]
    return keys


def export_artifact(
    path: str,
    params,
    *,
    features: str | None = None,
    source: str | dict[str, Any] | None = None,
    extra: dict[str, Any] | None = None,
) -> str:
    """Write ``params`` (an ``SSFNParams`` of tensors, or anything with a
    ``.params`` attribute) as an artifact directory; returns ``path``.

    ``features`` records the frozen extractor spec (validated here so a
    bad spec fails at export, not at the first request); ``source`` is
    free-form provenance."""
    if hasattr(params, "params"):
        params = params.params
    if not isinstance(params, SSFNParams):
        raise TypeError(
            f"expected SSFNParams (or a result carrying .params), got "
            f"{type(params).__name__}"
        )
    parse_features(features)  # validate the spec before anything lands
    o_list = [torch.as_tensor(o).detach().to("cpu", torch.float32) for o in params.o]
    r_list = [torch.as_tensor(r).detach().to("cpu", torch.float32) for r in params.r]
    q, p = _validate_stack(o_list, r_list, path=path)

    os.makedirs(path, exist_ok=True)
    weights = {
        "o": {str(i): o for i, o in enumerate(o_list)},
        "r": {str(i): r for i, r in enumerate(r_list)},
    }
    # Weights first, manifest last: the manifest at its final name is the
    # artifact's commit point (mirrors the checkpoint sidecar ordering).
    save_pytree(os.path.join(path, WEIGHTS_NAME), weights)
    manifest = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "weights": WEIGHTS_NAME,
        "num_classes": q,
        "input_dim": p,
        "num_readouts": len(o_list),
        "activation": "relu",
        "dtype": "float32",
        "features": features if features not in (None, "identity") else None,
        "source": source,
    }
    if extra:
        manifest.update(extra)
    _atomic_write(
        os.path.join(path, MANIFEST_NAME),
        lambda f: f.write(json.dumps(manifest, indent=2).encode()),
    )
    return path


def export_from_checkpoint(
    checkpoint: str, path: str, *, features: str | None = None
) -> str:
    """Convert a training checkpoint (a ``--checkpoint-dir`` directory,
    whose deepest complete checkpoint is taken, or a single
    ``dssfn_layer_NNN.npz``) into a serving artifact; returns ``path``.

    Reads the flat state ``layerwise._save_checkpoint`` (or ``repro``'s)
    wrote, with no trainer and no backend.  The checkpoint's own
    ``layer_next`` scalar determines how many readouts exist; the random
    matrices are taken verbatim from its ``r/*`` entries (the divergence
    guard may have redrawn them, so the key alone does not determine
    them).  A corrupt or foreign file raises :class:`ArtifactCorruptError`.
    """
    from repro_torch.core.layerwise import latest_checkpoint

    ckpt_path = checkpoint
    if os.path.isdir(checkpoint):
        ckpt_path = latest_checkpoint(checkpoint)
        if ckpt_path is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {checkpoint!r}"
            )
    try:
        flat = load_pytree_flat(ckpt_path)
    except CheckpointCorruptError as e:
        raise ArtifactCorruptError(
            ckpt_path, f"source checkpoint is corrupt ({e.detail})"
        ) from e
    if "layer_next" not in flat:
        raise ArtifactCorruptError(
            ckpt_path, "not a dSSFN training checkpoint (no layer_next)"
        )
    num_readouts = int(flat["layer_next"])
    missing = [k for k in _weight_keys(num_readouts) if k not in flat]
    if missing:
        raise ArtifactCorruptError(
            ckpt_path,
            f"checkpoint lacks weight entries {missing} (checkpoints of "
            "the older schema stored no r/*; re-train or pass SSFNParams "
            "to export_artifact)",
        )
    params = SSFNParams(
        o=tuple(flat[f"o/{i}"] for i in range(num_readouts)),
        r=tuple(flat[f"r/{i}"] for i in range(num_readouts - 1)),
    )
    return export_artifact(
        path, params, features=features, source=os.path.abspath(ckpt_path)
    )


def load_artifact(path: str) -> ServeArtifact:
    """Read + validate an artifact directory.  Raises
    :class:`ArtifactCorruptError` for every way it can be bad."""
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path):
        raise ArtifactCorruptError(path, "not a directory")
    if not os.path.exists(manifest_path):
        raise ArtifactCorruptError(
            path, f"manifest {MANIFEST_NAME!r} is missing (incomplete export?)"
        )
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ArtifactCorruptError(path, f"unreadable manifest ({e})") from e
    if not isinstance(manifest, dict) or manifest.get("format") != ARTIFACT_FORMAT:
        fmt = manifest.get("format") if isinstance(manifest, dict) else None
        raise ArtifactCorruptError(
            path, f"manifest format {fmt!r} is not {ARTIFACT_FORMAT!r}"
        )
    version = manifest.get("version")
    if version != ARTIFACT_VERSION:
        raise ArtifactCorruptError(
            path,
            f"artifact version {version!r} unsupported (this build reads "
            f"v{ARTIFACT_VERSION})",
        )
    for field_name in ("num_classes", "input_dim", "num_readouts"):
        if not isinstance(manifest.get(field_name), int):
            raise ArtifactCorruptError(
                path, f"manifest field {field_name!r} missing or non-integer"
            )
    if manifest.get("activation") != "relu":
        raise ArtifactCorruptError(
            path,
            f"unknown activation {manifest.get('activation')!r} "
            "(v1 serves relu stacks)",
        )
    num_readouts = manifest["num_readouts"]
    weights_path = os.path.join(path, manifest.get("weights", WEIGHTS_NAME))
    try:
        flat = load_pytree_flat(
            weights_path, expect_keys=_weight_keys(num_readouts)
        )
    except CheckpointCorruptError as e:
        raise ArtifactCorruptError(path, f"bad weights: {e.detail}") from e
    o_list = [flat[f"o/{i}"] for i in range(num_readouts)]
    r_list = [flat[f"r/{i}"] for i in range(num_readouts - 1)]
    q, p = _validate_stack(o_list, r_list, path=path)
    if q != manifest["num_classes"] or p != manifest["input_dim"]:
        raise ArtifactCorruptError(
            path,
            f"weights are (Q={q}, P={p}) but the manifest records "
            f"(Q={manifest['num_classes']}, P={manifest['input_dim']})",
        )
    features = manifest.get("features")
    try:
        parse_features(features)
    except ValueError as e:
        raise ArtifactCorruptError(path, f"bad feature spec: {e}") from e
    return ServeArtifact(
        params=SSFNParams(o=tuple(o_list), r=tuple(r_list)),
        num_classes=q,
        input_dim=p,
        activation=manifest["activation"],
        features=features,
        version=version,
        manifest=manifest,
        path=path,
    )


def is_valid_artifact(path: str) -> bool:
    """True iff the artifact loads and validates end to end (the serve
    launcher's boot predicate and the corruption drills' assertion)."""
    try:
        load_artifact(path)
    except (ArtifactCorruptError, OSError):
        return False
    return True
