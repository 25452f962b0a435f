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

The executor's half (a grid of ranks runs what the plan describes):

- :func:`shard_params_by_name` slices a whole parameter tree into one
  rank's shard, leaf by leaf, by ``launch/specs.param_spec_tree`` (the
  dry runs read the same spec trees, so planner and executor read one
  layout; a dim the spec leaves whole because it does not divide stays
  whole on every rank); :func:`unshard_params` puts every rank's shard
  back together and :func:`gather_params` does it over a running grid;
- ``sharding/parallel.py`` holds the collectives that take GSPMD's
  place inside the models.

No counterpart: ``shard`` and ``named_sharding`` (``with_sharding_
constraint`` and ``NamedSharding`` on a lowered program; the port's
models call ``sharding/parallel.py`` where ``repro``'s call ``shard``),
and ``shard_map_compat`` (the MoE's tensor-parallel path runs eagerly on
each rank, ``nn/moe.py``).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

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


# ------------------------------------------------------------- executor

def shard_index(shape, spec, plan: MeshPlan, coords: dict) -> tuple:
    """The slices of a leaf of ``shape`` sharded as ``spec`` that the rank
    at ``coords`` (its index along each axis of ``plan``) holds: a dim
    split over a tuple of axes is cut in the tuple's order, the first
    axis slowest, as ``jax`` lays a ``PartitionSpec`` entry out."""
    sizes = plan.axis_sizes
    out = []
    for dim, names in zip(shape, spec):
        axes = () if names is None else (names if isinstance(names, tuple) else (names,))
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        out.append(slice(None) if n == 1 else slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def shard_params_by_name(tree, rules: AxisRules, plan: MeshPlan, coords: dict, specs=None):
    """The rank at ``coords``'s shard of ``tree`` (a dict tree of tensors
    or numpy arrays), each leaf sliced by its spec under ``rules`` on
    ``plan`` (``specs``, or ``launch/specs.param_spec_tree(tree, ...)``)
    and copied (a tensor's shard owns its storage, so the whole leaf can
    be freed)."""
    from repro_torch.launch.specs import lookup, param_spec_tree, tree_map_with_path

    specs = param_spec_tree(tree, rules, plan) if specs is None else specs

    def cut(path, leaf):
        block = leaf[shard_index(leaf.shape, lookup(specs, path), plan, coords)]
        return block.clone() if isinstance(block, torch.Tensor) else np.array(block)

    return tree_map_with_path(cut, tree)


def unshard_params(shards: list, specs, plan: MeshPlan):
    """The whole tree from every rank's shard (``shards`` in rank order,
    ``repro``'s rank order over ``plan``; tensors or numpy arrays) and the
    spec tree they were cut by: the inverse of
    :func:`shard_params_by_name`."""
    from repro_torch.launch.specs import lookup, tree_map_with_path

    coords = [dict(zip(plan.axis_names, (int(i) for i in np.unravel_index(r, plan.shape))))
              for r in range(plan.size)]

    def join(path, first):
        spec = tuple(lookup(specs, path)) + (None,) * first.ndim
        parts = [lookup(s, path) for s in shards]
        shape = tuple(d * axes_size(names, plan) for d, names in zip(first.shape, spec))
        if isinstance(first, torch.Tensor):
            out = torch.empty(shape, dtype=first.dtype, device=first.device)
        else:
            out = np.empty(shape, dtype=first.dtype)
        for c, part in zip(coords, parts):
            out[shard_index(shape, spec, plan, c)] = part
        return out

    return tree_map_with_path(join, shards[0])


def axes_size(names, plan: MeshPlan) -> int:
    """How many blocks a spec entry (an axis, a tuple of axes or None)
    cuts its dim into on ``plan``."""
    if names is None:
        return 1
    n = 1
    for a in (names if isinstance(names, tuple) else (names,)):
        n *= plan.axis_sizes[a]
    return n


def gather_params(tree, specs, grid):
    """The whole tree, on the host, from this rank's shard over a running
    grid (a :class:`~repro_torch.launch.mesh.ModelGroup`), leaf by leaf:
    each split dim all-gathered over the model row, then over the data
    column, and the whole leaf moved to the CPU before the next is
    gathered, so the card never holds more than one whole leaf; every
    rank gets the tree."""
    from repro_torch.launch.specs import lookup, tree_map_with_path
    from repro_torch.sharding.parallel import all_gather_dim

    model, data = grid.rules.model_axis, set(grid.rules.data_axes)

    def join(path, leaf):
        for dim, names in enumerate(lookup(specs, path)):
            axes = () if names is None else (names if isinstance(names, tuple) else (names,))
            if model in axes:
                leaf = all_gather_dim(grid.model, leaf, dim)
            elif axes and set(axes) <= data:
                leaf = all_gather_dim(grid.data, leaf, dim)
        return leaf.cpu()

    return tree_map_with_path(join, tree)


def is_split(spec, axes) -> bool:
    """Whether ``spec`` splits some dim over one of ``axes``."""
    for names in spec:
        got = () if names is None else (names if isinstance(names, tuple) else (names,))
        if set(got) & set(axes):
            return True
    return False


def param_shapes_meta(cfg):
    """A zoo model's whole parameters as ``meta`` tensors (shapes only,
    f32), by ``cfg.family`` (``convert.param_shapes``)."""
    from repro_torch.convert import param_shapes

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    return meta(param_shapes(cfg))


def param_specs(cfg, rules: AxisRules, plan: MeshPlan):
    """The spec tree of a zoo model's whole parameters (every family)
    under ``rules`` on ``plan``, from their shapes alone."""
    from repro_torch.launch.specs import param_spec_tree

    return param_spec_tree(param_shapes_meta(cfg), rules, plan)


def init_shard(model, grid, seed: int = 0):
    """This rank's shard of ``model.init(Generator(device).manual_seed(
    seed))``: the ranks draw the whole seeded tree on their device one at
    a time (a barrier between turns), each keeping its shard and freeing
    the rest, so the device holds one whole copy at most beside the
    shards; every rank's shard is a block of the same numbers a one-rank
    run draws on that device."""
    specs = param_specs(model.cfg, grid.rules, grid.plan)
    shard = None
    for turn in range(grid.size):
        if turn == grid.rank:
            full = model.init(torch.Generator(device=grid.device).manual_seed(seed))
            shard = shard_params_by_name(full, grid.rules, grid.plan, grid.coords, specs)
            del full
            if grid.device.type == "cuda":
                torch.cuda.empty_cache()
        grid.world.barrier()
    return shard
