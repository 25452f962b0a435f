"""Running a model on a (data, model) grid of ranks: the port's
counterpart of GSPMD's sharding constraints and of ``shard_map_compat``.

``repro`` annotates activations with ``shard(...)`` and lets GSPMD place
the weights by ``PARAM_RULES``; its MoE runs a hand-written
``shard_map`` region.  The port runs every rank's share eagerly and
runs the collectives itself, over a
:class:`~repro_torch.launch.mesh.ModelGroup` made current with
:func:`use_grid` (with no grid current, every function here returns its
input and the models run as on one device).  The layout, Megatron's:

- the batch is split over the data axes (each data row holds B / data
  sequences), and within a model row every rank holds the same
  activations;
- a ``"T"`` weight is split over the model axis: a column-parallel
  product (``wq``/``wk``/``wv``, ``wg``/``wu``, ``in_x``/``in_z``,
  ``wx``, ``head``) takes its input through :func:`enter_model`, a
  row-parallel one (``wo``, ``wd``, ``out``) is :func:`row_parallel`:
  its partial sum kept in f32 through :func:`leave_model` and rounded to
  the model's dtype once, after the sum;
- a leaf or an activation that is whole on every rank of the row but
  feeds only this rank's heads or channels (Mamba2's ``a_log``,
  ``dt_bias``, ``conv_b``, ``gn`` and ``dt``, the mLSTM's gate
  pre-activations, the sLSTM's ``rw``) is cut by :func:`slice_model`; a
  whole activation every rank's heads read (Mamba2's B and C) goes
  through :func:`enter_model`, whose backward sums the heads' parts; a
  norm over split channels adds its sum of squares over the row
  (:func:`sum_over_model`);
- an ``"F"`` weight is split over the data axes (FSDP) and all-gathered
  where it is used (:func:`fsdp`), one layer at a time; the gather's
  backward reduce-scatters the gradient;
- the loss a data row computes is its part of the global loss, so the
  global loss and every gradient are sums over the data rows, and a
  value every data row must agree on (the MoE router's statistics) is
  their mean (:func:`mean_over_data`).

The conjugate pairs (``torch.autograd.Function``s):

============================  ==============================  ===========================
function                      forward                         backward
============================  ==============================  ===========================
:func:`enter_model`           identity                        all-reduce over model
:func:`leave_model`           all-reduce over model           identity
:func:`gather_data`           all-gather over data            reduce-scatter over data
:func:`gather_model`          all-gather over model           this rank's slice, or
                                                              (``scatter``) reduce-scatter
                                                              over model
:func:`slice_model`           this rank's block               all-gather over model
:func:`sum_over_model`        all-reduce over model (f32)     all-reduce over model
:func:`mean_over_data`        all-reduce mean over data       all-reduce mean over data
============================  ==============================  ===========================

Every cross-rank sum is taken in f32 (the payload is cast to f32 for the
wire and the result cast back), as ``repro`` takes its ``psum``s
(``nn/moe.py``); an all-gather carries its input's dtype unless the
caller names a wire dtype.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.sharding.rules import PARAM_RULES

_state = threading.local()


def current_grid():
    """The :class:`~repro_torch.launch.mesh.ModelGroup` made current by
    :func:`use_grid`, or None."""
    return getattr(_state, "grid", None)


@contextlib.contextmanager
def use_grid(grid):
    """Run the models over ``grid`` (None: as on one device) inside the
    block, with its :class:`AxisRules` current too."""
    from repro_torch.sharding.rules import use_rules

    prev = current_grid()
    _state.grid = grid
    try:
        if grid is None:
            yield grid
        else:
            with use_rules(grid.rules):
                yield grid
    finally:
        _state.grid = prev


# ------------------------------------------------------------ transports

def sum_f32(transport, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over ``transport``'s ranks, taken in f32
    and returned in ``x``'s dtype; ``x`` itself on one rank."""
    if transport.size == 1:
        return x
    return transport.all_reduce(x.float(), op).to(x.dtype)


def all_gather_dim(transport, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    if transport.size == 1:
        return x
    dim = dim % x.ndim
    return transport.all_gather(x.movedim(dim, 0)).movedim(0, dim)


def reduce_scatter_dim(transport, x: torch.Tensor, dim: int) -> torch.Tensor:
    """The f32 sum over the ranks of ``x``, this rank's block along
    ``dim``, in ``x``'s dtype."""
    if transport.size == 1:
        return x
    dim = dim % x.ndim
    out = transport.reduce_scatter(x.float().movedim(dim, 0))
    return out.movedim(0, dim).to(x.dtype)


# --------------------------------------------------------- the functions

class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_f32(ctx.transport, g), None


class _LeaveModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transport):
        return sum_f32(transport, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return sum_f32(transport, x)

    @staticmethod
    def backward(ctx, g):
        return sum_f32(ctx.transport, g), None


class _Slice(torch.autograd.Function):
    """This rank's block along ``dim``; the backward all-gathers the
    blocks' gradients, so every rank holds the whole one."""

    @staticmethod
    def forward(ctx, x, transport, dim):
        if x.shape[dim] % transport.size:
            raise ValueError(f"a dim of {x.shape[dim]} entries does not split over "
                             f"{transport.size} ranks")
        ctx.transport, ctx.dim = transport, dim
        n = x.shape[dim] // transport.size
        return x.narrow(dim, transport.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(ctx.transport, g, ctx.dim), None, None


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` (a (..., K), b (K, N) or batched alike) with the product
    returned in f32, unrounded: on the card cuBLAS's ``out_dtype`` (the
    operands stay bf16 on the tensor cores; ``aten::mm.dtype`` has no
    derivative, hence this Function), on the CPU the operands upcast (no
    CPU kernel takes ``out_dtype``).  The backward takes the
    gradient in the operands' dtype, as the one-device product's does:
    the caller rounds the (summed) result to that dtype, so the gradient
    arrives as values of it."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type != "cuda":
            return a.float() @ b.float()
        if b.ndim == 2:
            flat = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return flat.reshape(a.shape[:-1] + (b.shape[-1],))
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.transpose(-1, -2)
        if b.ndim == 2:
            gb = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        else:
            gb = a.transpose(-1, -2) @ g
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in f32 and returned unrounded (``a @ b`` itself
    for f32 operands): the partial product of a row-parallel matrix
    product, rounded once after the sum over the model row."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    return _MatmulF32.apply(a, b)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward sums the gradient over the
    ranks and keeps this rank's block (``scatter``), or only keeps it
    (every rank computed the same gradient)."""

    @staticmethod
    def forward(ctx, w, transport, dim, wire_dtype, scatter):
        ctx.transport, ctx.dim, ctx.scatter, ctx.dtype = transport, dim, scatter, w.dtype
        ctx.rows = w.shape[dim]
        src = w if wire_dtype is None else w.to(wire_dtype)
        return all_gather_dim(transport, src, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            out = reduce_scatter_dim(ctx.transport, g, ctx.dim)
        else:
            r = ctx.transport.rank
            out = g.narrow(ctx.dim, r * ctx.rows, ctx.rows)
        return out.to(ctx.dtype), None, None, None, None


class _MeanData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return _mean(transport, x)

    @staticmethod
    def backward(ctx, g):
        return _mean(ctx.transport, g), None


def _mean(transport, x):
    return (sum_f32(transport, x.float()) / transport.size).to(x.dtype)


def _model(grid):
    return None if grid is None or grid.model.size == 1 else grid.model


def _data(grid):
    return None if grid is None or grid.data.size == 1 else grid.data


def enter_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product: identity, whose gradient
    is summed over the model row (each rank's columns give a part)."""
    t = _model(current_grid())
    return x if t is None else _EnterModel.apply(x, t)


def leave_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product: the partial sums added over
    the model row (f32); the gradient passes as it is."""
    t = _model(current_grid())
    return x if t is None else _LeaveModel.apply(x, t)


def gather_data(w: torch.Tensor, dim: int, wire_dtype: torch.dtype | None = None):
    """``w``'s blocks along ``dim`` gathered over the data axes (the FSDP
    all-gather, in ``wire_dtype`` if given); the backward reduce-scatters
    the gradient in f32 and returns it in ``w``'s dtype."""
    t = _data(current_grid())
    if t is None:
        return w if wire_dtype is None else w.to(wire_dtype)
    return _Gather.apply(w, t, dim % w.ndim, wire_dtype, True)


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The row-parallel product ``x @ w`` on a grid (x this rank's
    columns, w its rows): each rank's partial product kept in f32
    (:func:`matmul_f32`), added over the model row in f32 and rounded to
    x's dtype once, as one device's product rounds its f32 sum once; an
    f32 model's product as it was."""
    t = _model(current_grid())
    if t is None:
        return x @ w
    return _LeaveModel.apply(matmul_f32(x, w), t).to(x.dtype)


def gather_model(w: torch.Tensor, dim: int, *, scatter: bool = False) -> torch.Tensor:
    """``w``'s blocks along ``dim`` gathered over the model row.  The
    backward keeps this rank's block of the gradient: of a row-wide
    identical one (every rank computes the product whole), or with
    ``scatter`` of its sum over the row, reduce-scattered in f32 (each
    rank's use of the whole tensor gives a part: the sLSTM reads its own
    heads' columns of every gate)."""
    t = _model(current_grid())
    return w if t is None else _Gather.apply(w, t, dim % w.ndim, None, scatter)


def slice_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which is whole on every
    rank of the model row (a whole leaf, or an activation a replicated
    product gave), for this rank's heads or channels; the backward
    all-gathers the blocks' gradients over the row, so the whole
    gradient is the same on every rank."""
    t = _model(current_grid())
    return x if t is None else _Slice.apply(x, t, dim % x.ndim)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model row, f32 on the wire (each rank's
    output reads the row-wide sum); the backward all-reduces the
    gradient, as every rank's use of the sum gives a part of it."""
    t = _model(current_grid())
    return x if t is None else _SumModel.apply(x, t)


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data rows (``jax.lax.pmean``), f32 on
    the wire; its adjoint is the same mean."""
    t = _data(current_grid())
    return x if t is None else _MeanData.apply(x, t)


def fsdp(w: torch.Tensor, name: str, full: int, wire_dtype: torch.dtype | None = None):
    """Parameter ``name`` (a :data:`~repro_torch.sharding.rules.PARAM_RULES`
    key) with its ``"F"`` dim whole: gathered over the data axes where
    this rank holds a block of it (its size is not ``full``), else as
    given (cast to ``wire_dtype`` if named, as after a gather)."""
    if current_grid() is None:
        return w if wire_dtype is None else w.to(wire_dtype)
    rule = PARAM_RULES[name]
    dim = w.ndim - len(rule) + rule.index("F")
    if w.shape[dim] == full:
        return w if wire_dtype is None else w.to(wire_dtype)
    return gather_data(w, dim, wire_dtype)


def model_split(local: int, full: int) -> bool:
    """Whether a ``"T"`` dim of ``full`` entries is split over the model
    row (this rank holds ``local`` of them)."""
    if local == full:
        return False
    grid = current_grid()
    if grid is None or local * grid.model_parallel != full:
        raise ValueError(f"a dim of {local} entries is no model shard of {full}")
    return True


# ------------------------------------------------------- vocab-parallel

def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """``argmax`` over the last axis of logits whose vocabulary is split
    over the model row in rank order (this rank holds ``logits.shape[-1]``
    entries from ``model_index * logits.shape[-1]``): the global index of
    the largest entry, ties to the lower index (``jnp.argmax``'s rule:
    the lowest rank among equal maxima, then the first within it)."""
    grid = current_grid()
    t = _model(grid)
    idx = torch.argmax(logits, dim=-1)
    if t is None:
        return idx
    vl = logits.shape[-1]
    best = torch.gather(logits, -1, idx[..., None])[..., 0]
    mine = torch.stack([best.double(), (idx + grid.model_index * vl).double()])
    every = t.all_gather(mine[None])                    # (mp, 2, ...)
    rank = torch.argmax(every[:, 0], dim=0)             # the first of equal maxima
    return torch.gather(every[:, 1], 0, rank[None])[0].long()
