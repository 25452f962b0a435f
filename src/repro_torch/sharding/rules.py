"""Sharding rules: logical axes resolved against a plan of the mesh.

Port of ``repro/sharding/rules.py`` as a plan, not a lowering.  The
logical axes are ``repro``'s:

  batch  -> ("pod", "data") or ("data",)   (data parallel)
  fsdp   -> same axes as batch             (FSDP weight sharding)
  tensor -> "model"                        (tensor / expert parallel)
  workers -> the dSSFN worker axis

``use_rules``/``current_rules`` make the rules available without
threading them through every call; with no rules active a logical axis
resolves as under ``AxisRules()``.  :func:`spec` returns a plain tuple
with one entry per dim (an axis name, a tuple of names, or None), in
``PartitionSpec``'s order; ``launch/specs.py`` resolves the name-based
weight rules :data:`PARAM_RULES` against a :class:`MeshPlan`.

No counterpart: ``shard``, ``named_sharding``, ``shard_params_by_name``
and ``shard_map_compat``.  They constrain GSPMD's partitioning of a
lowered program (``with_sharding_constraint``, ``NamedSharding``,
``shard_map``), and the port lowers nothing: its models run eagerly on
one card and never called them (``repro/models/blocks.py:51`` and the
like; the port's ``models/blocks.py`` has no such calls).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

from repro_torch.launch.mesh import MeshPlan


@dataclass(frozen=True)
class AxisRules:
    mesh: MeshPlan | None = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = "model"
    # Disable FSDP (weights replicated over data axes) if False.
    fsdp: bool = True
    # Axes carrying the FSDP/weight-row sharding; defaults to data_axes.
    # Setting fsdp_axes with data_axes=() gives the weight-stationary 2-D
    # TP decode layout: batch replicated, weights fully 2-D sharded.
    fsdp_axes: tuple[str, ...] | None = None
    # Shard the sequence dim of activations over data axes (for batch=1
    # long-context decode this is the only way to use the data axis).
    sequence_sharding: bool = False
    # Mesh axis carrying the dSSFN ADMM worker dimension (the leading
    # (M, ...) axis of per-worker Y_m/T_m stacks); None outside
    # decentralized-training launches.
    worker_axis: str | None = None

    @property
    def weight_axes(self) -> tuple[str, ...]:
        return self.fsdp_axes if self.fsdp_axes is not None else self.data_axes


_state = threading.local()


def current_rules() -> AxisRules:
    return getattr(_state, "rules", AxisRules())


@contextlib.contextmanager
def use_rules(rules: AxisRules):
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def _resolve(logical: str | None, rules: AxisRules):
    if logical is None:
        return None
    if logical == "batch":
        if not rules.data_axes:
            return None
        return rules.data_axes if len(rules.data_axes) > 1 else rules.data_axes[0]
    if logical == "fsdp":
        if not rules.fsdp or not rules.weight_axes:
            return None
        w = rules.weight_axes
        return w if len(w) > 1 else w[0]
    if logical == "tensor":
        return rules.model_axis
    if logical == "workers":
        return rules.worker_axis
    raise ValueError(f"unknown logical axis {logical!r}")


def spec(*logical_axes: str | None) -> tuple:
    """The mesh axes of each dim under the active rules."""
    rules = current_rules()
    return tuple(_resolve(a, rules) for a in logical_axes)


# Name-based weight-sharding rules (trailing dims; leading stacked-layer
# dims are replicated).  "F" = FSDP over the data axes, "T" = tensor
# parallel over the model axis.  ``repro``'s own copy, verbatim.
PARAM_RULES: dict[str, tuple[str | None, ...]] = {
    "embed": ("T", "F"),
    "head": ("F", "T"),
    "patch_proj": ("F", None),
    "wq": ("F", "T"),
    "wk": ("F", "T"),
    "wv": ("F", "T"),
    "wo": ("T", "F"),
    "wg": ("F", "T"),
    "wu": ("F", "T"),
    "wd": ("T", "F"),
    "router": ("F", None),
    "in_x": ("F", "T"),
    "in_z": ("F", "T"),
    "in_b": ("F", None),
    "in_c": ("F", None),
    "in_dt": ("F", None),
    "conv_w": (None, "T"),
    "out": ("T", "F"),
    "wx": ("F", "T"),
    "wi": ("F", None),
    "wf": ("F", None),
}
