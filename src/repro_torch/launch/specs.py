"""Input shapes and sharding specs for the dry runs and launchers.

Port of ``repro/launch/specs.py``.  ``batch_specs(cfg, shape_name)``
returns ``meta`` tensors (shape and dtype, no storage) standing in for
every model input, where ``repro`` returns ``ShapeDtypeStruct``s.  The
spec trees follow ``repro``'s rules exactly, over the port's trees and a
:class:`~repro_torch.launch.mesh.MeshPlan`:

- params: dicts of tensors, specs by leaf name from
  :data:`~repro_torch.sharding.rules.PARAM_RULES` (leading stacked-layer
  dims replicated), each non-dividing axis dropped;
- optimizer state: ``AdamW``'s ``{"step", "m", "v"}``, the moments
  mirroring the params;
- caches: the ``KVCache``, ``HybridCache`` and ``XLSTMCache`` NamedTuples,
  by shape (batch dim, KV slot dim, first divisible feature dim);
- the batch: its leading dim over the data axes where it divides.

A spec is a plain tuple, one entry per dim (an axis name, a tuple of
names, or None), or ``()`` for a replicated leaf (``repro``'s ``P()``).

No counterpart: ``to_shardings``, which wraps specs in ``NamedSharding``s
for ``jax.jit``.  In its place :func:`per_device_bytes` sizes what one
device of the plan holds of a tree.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import MeshPlan
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import PARAM_RULES as _PARAM_RULES
from repro_torch.sharding.rules import AxisRules

# ---------------------------------------------------------------- shapes

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str, *, batch: int | None = None,
                seq: int | None = None) -> dict[str, torch.Tensor]:
    """The inputs of ``shape_name``'s step; ``batch`` and ``seq`` replace
    the shape's own (a dry run traces one device's share of the batch)."""
    info = INPUT_SHAPES[shape_name]
    b, s = batch or info["batch"], seq or info["seq"]
    kind = info["kind"]
    i32 = torch.int32
    if kind == "decode":
        tok_shape = (b, 1, cfg.num_codebooks) if cfg.family == "audio" else (b, 1)
        return {"tokens": _meta(tok_shape, i32)}
    out: dict[str, Any] = {}
    if cfg.family == "audio":
        out["tokens"] = _meta((b, s, cfg.num_codebooks), i32)
        if kind == "train":
            out["labels"] = _meta((b, s, cfg.num_codebooks), i32)
        return out
    s_text = s - cfg.num_patches if cfg.family == "vlm" else s
    out["tokens"] = _meta((b, s_text), i32)
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((b, cfg.num_patches, cfg.patch_dim), torch.bfloat16)
    if kind == "train":
        out["labels"] = _meta((b, s_text), i32)
    return out


# ------------------------------------------------------------------ trees

def tree_map_with_path(fn, tree, path: tuple = ()):
    """``jax.tree_util.tree_map_with_path`` over the port's trees: dicts
    (a path entry is the key), NamedTuples, tuples and lists (the index)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree, path: tuple = ()) -> list:
    """``(path, leaf)`` for every leaf, in ``jax.tree.leaves`` order
    (dict keys sorted; a spec tuple is a leaf only where it stands for a
    tensor, so call this on the tensor tree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def lookup(tree, path: tuple):
    """The subtree of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------ param specs

def _resolve_axis(tag, rules: AxisRules):
    if tag == "F":
        if not rules.fsdp or not rules.weight_axes:
            return None
        w = rules.weight_axes
        return w if len(w) > 1 else w[0]
    if tag == "T":
        return rules.model_axis
    return None


def _leaf_name(path) -> str:
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def axis_count(names, plan: MeshPlan) -> int:
    """Devices a dim is split over: the product of its axes' sizes."""
    if names is None:
        return 1
    sizes = plan.axis_sizes
    total = 1
    for n in (names if isinstance(names, tuple) else (names,)):
        total *= sizes[n]
    return total


def _divisible(shape, spec, plan: MeshPlan) -> bool:
    return all(dim % axis_count(names, plan) == 0 for dim, names in zip(shape, spec))


def param_spec_tree(params, rules: AxisRules, plan: MeshPlan):
    """A spec for every parameter leaf, in the params' structure."""

    def assign(path, leaf):
        rule = _PARAM_RULES.get(_leaf_name(path))
        if rule is None or leaf.ndim < len(rule):
            return ()
        lead = leaf.ndim - len(rule)
        spec = [None] * lead + [_resolve_axis(t, rules) for t in rule]
        # Drop shardings that do not divide (GSPMD would pad; for weights
        # exactness is preferred).
        if not _divisible(leaf.shape, spec, plan):
            spec = [names if dim % axis_count(names, plan) == 0 else None
                    for dim, names in zip(leaf.shape, spec)]
        return tuple(spec)

    return tree_map_with_path(assign, params)


def opt_state_spec_tree(opt_state, param_specs):
    """Adam m/v mirror the param specs; counters replicate."""

    def assign(path, leaf):
        if path and path[0] in ("m", "v"):
            spec = lookup(param_specs, path[1:])
            return spec if isinstance(spec, tuple) else ()
        return ()

    return tree_map_with_path(assign, opt_state)


# ------------------------------------------------------------ cache specs

def _bspec(batch: int, rules: AxisRules, plan: MeshPlan) -> Any:
    if not rules.data_axes:
        return None
    names = rules.data_axes if len(rules.data_axes) > 1 else rules.data_axes[0]
    return names if batch % axis_count(names, plan) == 0 else None


def _tspec(dim: int, rules: AxisRules, plan: MeshPlan) -> Any:
    if rules.model_axis and dim % plan.axis_sizes[rules.model_axis] == 0:
        return rules.model_axis
    return None


def cache_spec_tree(cache, cfg: ModelConfig, batch: int, rules: AxisRules, plan: MeshPlan):
    """Specs for decode caches: batch over data axes, heads/features over
    the model axis when divisible, stacked-layer dims replicated.

    Cache trees are NamedTuples (no string keys), so assignment is
    shape-based: the first dim equal to the global batch is the batch dim;
    a very large following dim (> 512) is a KV slot dim (kept unsharded —
    decode writes one slot there); the first divisible head/feature dim
    after that shards over the model axis.
    """
    b = _bspec(batch, rules, plan)

    def assign(path, leaf):
        shape = leaf.shape
        spec: list[Any] = [None] * leaf.ndim
        for i, d in enumerate(shape):
            if d == batch:
                spec[i] = b
                start = i + 1
                if start < leaf.ndim and shape[start] > 512:
                    start += 1  # slot dim of a KV cache: never sharded
                for jdim in range(start, leaf.ndim):
                    t = _tspec(shape[jdim], rules, plan)
                    if t is not None and shape[jdim] > 1:
                        spec[jdim] = t
                        break
                break
        return tuple(spec)

    return tree_map_with_path(assign, cache)


def batch_spec_tree(specs: dict, rules: AxisRules, plan: MeshPlan, batch: int):
    b = _bspec(batch, rules, plan)
    return {k: (b,) + (None,) * (v.ndim - 1) for k, v in specs.items()}


# ------------------------------------------------------------------ bytes

def per_device_bytes(tree, spec_tree, plan: MeshPlan) -> int:
    """The bytes one device of ``plan`` holds of ``tree`` sharded as
    ``spec_tree``: each leaf's bytes over the devices its dims split over
    (every spec here divides its dim)."""
    total = 0
    for path, leaf in leaves_with_path(tree):
        spec = lookup(spec_tree, path)
        split = 1
        for names in spec:
            split *= axis_count(names, plan)
        total += leaf.numel() * leaf.element_size() // split
    return total
