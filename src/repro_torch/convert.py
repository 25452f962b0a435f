"""Carry SSFN parameters, random matrices, datasets and model-zoo
(transformer of every family, hybrid and xLSTM) parameters and optimizer
states between ``repro`` (as numpy arrays) and the port.

``repro``'s arrays are JAX arrays; ``np.asarray`` on each gives what
these functions take and return, so neither package imports the other.
The two packages draw random numbers differently, so carrying ``repro``'s
R matrices and data across is how the same training problem reaches both.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.ssfn import SSFNParams
from repro_torch.data.synthetic import Dataset
from repro_torch.models.config import ModelConfig


def params_from_numpy(
    o_list: Sequence[np.ndarray],
    r_list: Sequence[np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> SSFNParams:
    """``SSFNParams`` of tensors on ``device`` (``None`` means ``cuda``,
    and raises without it) from the readouts O_0..O_L and the random
    matrices R_1..R_L."""
    dev = resolve_device(device)

    def conv(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return SSFNParams(
        o=tuple(conv(o) for o in o_list), r=tuple(conv(r) for r in r_list)
    )


def params_to_numpy(
    params: SSFNParams,
) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(O list, R list) as host numpy arrays; bf16 comes back as f32,
    which holds every bf16 value exactly."""

    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return [conv(o) for o in params.o], [conv(r) for r in params.r]


def r_from_numpy(
    r_list: Sequence[np.ndarray],
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """The random matrices R_1..R_L as tensors on ``device`` (``None``
    means ``cuda``), for ``train_decentralized_ssfn(r=...)``."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(r), dtype=dtype, device=dev) for r in r_list)


def dataset_from_numpy(data, *, device: str | torch.device | None = None) -> Dataset:
    """A :class:`repro_torch.data.Dataset` on ``device`` (``None`` means
    ``cuda``) from anything with the six fields ``x_train``, ``t_train``,
    ``y_train``, ``x_test``, ``t_test`` and ``y_test`` (``repro``'s
    ``Dataset`` among them): features and targets as f32, labels as
    int64."""
    dev = resolve_device(device)

    def conv(name, dtype):
        return torch.tensor(np.asarray(getattr(data, name)), dtype=dtype, device=dev)

    return Dataset(
        x_train=conv("x_train", torch.float32),
        t_train=conv("t_train", torch.float32),
        y_train=conv("y_train", torch.int64),
        x_test=conv("x_test", torch.float32),
        t_test=conv("t_test", torch.float32),
        y_test=conv("y_test", torch.int64),
    )


def _layer_shapes(cfg: ModelConfig, stack: tuple[int, ...]) -> dict[str, Any]:
    """One transformer layer's parameter shapes, with leading ``stack`` axes."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    if cfg.num_experts:
        e = stack + (cfg.num_experts,)
        ffn = {"router": stack + (d, cfg.num_experts), "wg": e + (d, f), "wu": e + (d, f),
               "wd": e + (f, d)}
    else:
        ffn = {"wg": stack + (d, f), "wu": stack + (d, f), "wd": stack + (f, d)}
    return {
        "ln1": stack + (d,),
        "ln2": stack + (d,),
        "attn": {"wq": stack + (d, q), "wk": stack + (d, kv), "wv": stack + (d, kv),
                 "wo": stack + (q, d)},
        "ffn": ffn,
    }


def transformer_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter of a transformer (dense, MoE, VLM or
    audio), as a tree with the reference's names: per-layer weights
    stacked on a leading L axis; an audio model's nc embeddings stacked
    and its nc heads side by side; a VLM's patch projector."""
    d, v = cfg.d_model, cfg.padded_vocab
    shapes = {"layers": _layer_shapes(cfg, (cfg.num_layers,)), "ln_f": (d,)}
    if cfg.family == "audio":
        nc = cfg.num_codebooks
        shapes.update(embed=(nc, v, d), head=(d, nc * v))
    else:
        shapes.update(embed=(v, d), head=(d, v))
    if cfg.family == "vlm":
        shapes["patch_proj"] = (cfg.patch_dim, d)
    return shapes


def hybrid_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter of a hybrid (Mamba2 + shared attention)
    model, with the reference's names: the Mamba weights stacked on leading
    (num_periods, per_period) axes and one shared transformer layer."""
    d, v, di = cfg.d_model, cfg.padded_vocab, cfg.d_inner_eff
    ds, h = cfg.ssm_state, cfg.ssm_heads
    pm = (cfg.num_layers // cfg.shared_attn_period, cfg.shared_attn_period)
    return {
        "embed": (v, d),
        "mamba": {
            "ln": pm + (d,), "in_x": pm + (d, di), "in_z": pm + (d, di),
            "in_b": pm + (d, ds), "in_c": pm + (d, ds), "in_dt": pm + (d, h),
            "conv_w": pm + (cfg.conv_kernel, di), "conv_b": pm + (di,),
            "a_log": pm + (h,), "dt_bias": pm + (h,), "gn": pm + (di,),
            "out": pm + (di, d),
        },
        "shared_attn": _layer_shapes(cfg, ()),
        "ln_f": (d,),
        "head": (d, v),
    }


def xlstm_param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape of every parameter of an xLSTM model, with the reference's
    names: the mLSTM weights stacked on leading (num_periods,
    mlstm_per_period) axes, the sLSTM weights on a leading num_periods
    axis (allocated whether or not the config applies them)."""
    d, v, h, hd = cfg.d_model, cfg.padded_vocab, cfg.num_heads, cfg.hd
    period = cfg.slstm_period or 1
    periods = cfg.num_layers // period
    pm = (periods, period - 1 if cfg.slstm_period > 1 else 1)
    p, dh = (periods,), d // h
    return {
        "embed": (v, d),
        "mlstm": {
            "ln": pm + (d,), "wq": pm + (d, h * hd), "wk": pm + (d, h * hd),
            "wv": pm + (d, h * hd), "wi": pm + (d, h), "wf": pm + (d, h),
            "gn": pm + (h * hd,), "out": pm + (h * hd, d),
        },
        "slstm": {
            "ln": p + (d,), "wx": p + (d, 4 * d), "rw": p + (4, h, dh, dh), "gn": p + (d,),
            "out": p + (d, d),
        },
        "ln_f": (d,),
        "head": (d, v),
    }


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """The shape tree of ``cfg``'s parameters, by family: a hybrid's
    (:func:`hybrid_param_shapes`), an xLSTM's (:func:`xlstm_param_shapes`)
    or a transformer's (:func:`transformer_param_shapes`)."""
    if cfg.family == "hybrid":
        return hybrid_param_shapes(cfg)
    if cfg.family == "ssm":
        return xlstm_param_shapes(cfg)
    return transformer_param_shapes(cfg)


#: Transformer parameters that ``repro`` keeps in f32 whatever the model's
#: dtype: the MoE router.
_TRANSFORMER_F32 = {("layers", "ffn", "router")}
#: Hybrid parameters that ``repro`` keeps in f32 whatever the model's dtype.
_HYBRID_F32 = {("mamba", "a_log"), ("mamba", "dt_bias")}
#: xLSTM parameters that ``repro`` keeps in f32 whatever the model's dtype:
#: the mLSTM gate projections and the sLSTM recurrent weights.
_XLSTM_F32 = {("mlstm", "wi"), ("mlstm", "wf"), ("slstm", "rw")}


def _tree_from_numpy(tree, shapes, dev: torch.device, dt: torch.dtype, keep_f32=frozenset(),
                     cut=None):
    """Tensors on ``dev`` from a tree of numpy arrays matching ``shapes``:
    in ``dt``, except the leaves whose key path is in ``keep_f32``.  A
    tree whose keys or shapes differ raises ``ValueError``.  bf16 arrays
    (numpy has no bf16 of its own) go through f32, which holds every bf16
    value exactly.  ``cut(path, array)``, if given, slices each array on
    the host before it is copied (a rank's shard)."""

    def conv(node, shape, path):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                where = "".join(f"[{k!r}]" for k in path)
                raise ValueError(f"params{where}: expected keys {sorted(shape)}, got {got}")
            return {k: conv(node[k], shape[k], path + (k,)) for k in shape}
        a = np.asarray(node)
        if a.shape != shape:
            where = "".join(f"[{k!r}]" for k in path)
            raise ValueError(f"params{where}: expected shape {shape}, got {a.shape}")
        if cut is not None:
            a = cut(path, a)
        if a.dtype.kind != "f" or a.dtype.itemsize < 4:   # bf16 and f16
            a = a.astype(np.float32)
        leaf_dt = torch.float32 if path in keep_f32 else dt
        return torch.tensor(a, dtype=leaf_dt, device=dev)  # a copy, never a view of `tree`

    return conv(tree, shapes, ())


def transformer_params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, Any]:
    """The port's parameters (tensors on ``device``, ``None`` meaning
    ``cuda``; in ``dtype``, by default ``cfg.torch_dtype``) from
    ``jax.tree.map(np.asarray, params)`` of ``repro``'s
    ``TransformerModel.init``.  Names and layouts are the same, and an MoE
    router stays f32 whatever ``dtype`` is, as ``repro`` keeps it; a tree
    whose keys or shapes do not match ``cfg`` raises ``ValueError``."""
    dt = cfg.torch_dtype if dtype is None else dtype
    return _tree_from_numpy(tree, transformer_param_shapes(cfg), resolve_device(device), dt,
                            _TRANSFORMER_F32)


def _f32_leaves(cfg: ModelConfig) -> set:
    """The key paths of ``cfg``'s family that ``repro`` keeps in f32."""
    return {"hybrid": _HYBRID_F32, "ssm": _XLSTM_F32}.get(cfg.family, _TRANSFORMER_F32)


def _shard_cut(cfg: ModelConfig, grid):
    """``cut`` for :func:`_tree_from_numpy`: each leaf's block on ``grid``'s
    rank, by the spec tree of ``cfg``'s whole parameters (any family)."""
    from repro_torch.sharding.rules import param_specs, shard_index

    specs = param_specs(cfg, grid.rules, grid.plan)

    def cut(path, a):
        spec = specs
        for k in path:
            spec = spec[k]
        return a[shard_index(a.shape, spec, grid.plan, grid.coords)]

    return cut


def shard_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    grid,
    *,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """This rank's shard on ``grid`` (a ``launch/mesh.ModelGroup``) of the
    tree :func:`transformer_params_from_numpy`, :func:`hybrid_params_from_
    numpy` or :func:`xlstm_params_from_numpy` gives for ``cfg``'s family:
    each array is sliced on the host by its spec
    (``sharding/rules.shard_params_by_name``'s layout) and only the slice
    is copied to ``device`` (the family's f32 leaves in f32), so no rank
    holds the whole weights there."""
    return _tree_from_numpy(tree, param_shapes(cfg), resolve_device(device), cfg.torch_dtype,
                            _f32_leaves(cfg), cut=_shard_cut(cfg, grid))



def params_from_shards(shards: list, cfg: ModelConfig, plan) -> dict[str, Any]:
    """The whole tree of host numpy arrays from every rank's shard, a tree
    of tensors (``shards`` in rank order over ``plan``): the inverse of
    :func:`shard_from_numpy` over the ranks, for any family.  An ``AdamW``
    moment tree goes back the same way."""
    from repro_torch.launch.mesh import data_axes_for
    from repro_torch.sharding.rules import AxisRules, param_specs, unshard_params

    rules = AxisRules(mesh=plan, data_axes=data_axes_for(plan), model_axis="model")
    host = [transformer_params_to_numpy(s) for s in shards]
    return unshard_params(host, param_specs(cfg, rules, plan), plan)



def opt_state_shard_from_numpy(
    state: dict[str, Any], cfg: ModelConfig, grid, *,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """This rank's shard of :func:`opt_state_from_numpy`'s state: the
    moments cut as the params are (``AdamW`` is elementwise, so a shard's
    state is the state of its params), ``step`` whole."""
    cut = _shard_cut(cfg, grid)
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        return torch.tensor(cut(path, np.asarray(node, np.float32)), device=dev)

    out = {k: conv(v, ()) for k, v in state.items() if k != "step"}
    out["step"] = torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=dev)
    return out


def hybrid_params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, Any]:
    """The port's hybrid parameters from ``jax.tree.map(np.asarray,
    params)`` of ``repro``'s ``HybridModel.init``, as
    :func:`transformer_params_from_numpy` carries a transformer's, except
    that ``mamba.a_log`` and ``mamba.dt_bias`` stay f32 whatever ``dtype``
    is, as ``repro`` keeps them."""
    dt = cfg.torch_dtype if dtype is None else dtype
    return _tree_from_numpy(tree, hybrid_param_shapes(cfg), resolve_device(device), dt,
                            _HYBRID_F32)


def xlstm_params_from_numpy(
    tree: dict[str, Any],
    cfg: ModelConfig,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> dict[str, Any]:
    """The port's xLSTM parameters from ``jax.tree.map(np.asarray,
    params)`` of ``repro``'s ``XLSTMModel.init``, as
    :func:`transformer_params_from_numpy` carries a transformer's, except
    that ``mlstm.wi``, ``mlstm.wf`` and ``slstm.rw`` stay f32 whatever
    ``dtype`` is, as ``repro`` keeps them."""
    dt = cfg.torch_dtype if dtype is None else dtype
    return _tree_from_numpy(tree, xlstm_param_shapes(cfg), resolve_device(device), dt,
                            _XLSTM_F32)


def transformer_params_to_numpy(params: dict[str, Any]) -> dict[str, Any]:
    """The inverse of :func:`transformer_params_from_numpy` (and of
    :func:`hybrid_params_from_numpy` and :func:`xlstm_params_from_numpy`):
    the same tree of host numpy arrays; bf16 comes back as f32."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(params)


hybrid_params_to_numpy = transformer_params_to_numpy
xlstm_params_to_numpy = transformer_params_to_numpy


def opt_state_from_numpy(
    state: dict[str, Any], *, device: str | torch.device | None = None
) -> dict[str, Any]:
    """An ``Sgd`` or ``AdamW`` state on ``device`` (``None`` means ``cuda``)
    from ``jax.tree.map(np.asarray, state)`` of ``repro``'s: ``step`` an
    int32 0-d tensor, the moments (``m``, and ``v`` for AdamW, each a tree
    like the params) f32, as both packages keep them."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.tensor(np.asarray(node, np.float32), device=dev)

    out = {k: conv(v) for k, v in state.items() if k != "step"}
    out["step"] = torch.tensor(np.asarray(state["step"]), dtype=torch.int32, device=dev)
    return out


def opt_state_to_numpy(state: dict[str, Any]) -> dict[str, Any]:
    """The inverse of :func:`opt_state_from_numpy`: the same tree of host
    numpy arrays (``step`` int32, the moments f32)."""
    return transformer_params_to_numpy(state)
