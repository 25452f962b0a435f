"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro/nn/moe.py``'s plain path.  Routing is batch-local: every
sequence routes its own tokens into per-expert capacity buffers, so
dispatch and combine never mix sequences.  The reference ``vmap``s one
sequence's routing over B; here the batch is a leading axis and the
scatters and gathers take flat (batch, expert, slot) indices, with no
Python loop over tokens and no host synchronization.  ``route`` and
``dispatch`` together are the reference's ``_route_one``, ``combine`` its
``_combine_one``, and ``moe_ffn`` the plain path of its ``_moe_core``.

On a (data, model) grid of ranks (``sharding/parallel.py``),
``moe_ffn_parallel`` takes the reference's ``shard_map`` tensor-parallel
path under its conditions (a model row of more than one rank, a hidden dim f
that splits over it, the model dim d over the data rows where FSDP is
on): each rank holds an f-slice of every expert, gathers the FSDP rows
of ``wg``, ``wu`` and ``wd`` over the data column in f32, routes and
dispatches its data row's sequences in full, runs its f-slice of each
expert, combines, and only then adds the partial (B, S, d) outputs over
the row in f32 (one all-reduce the size of a dense MLP's); the router's
statistics are averaged over the data rows.  Under any other condition
on a grid it takes the plain path on whole experts (their split dims
gathered).  On the backward pass the dispatched tokens' gradient and the
gates' (each rank's f-slice gives a part of both) are added over the
row, and the router's own terms, which every rank computes whole, are
not.

Semantics that decide routing and drops, as in the reference:

- router logits in f32 from the f32 router weights, softmax, then top-k,
  with ties going to the lower expert index (``jax.lax.top_k``'s rule:
  a stable descending sort, whose first k are taken);
- gates renormalised by ``max(sum, 1e-9)``;
- an assignment's slot in its expert is the running count of that
  expert over the token-major flattening (token t's k-th choice at
  t * K + k), and ``keep = slot < capacity``; a dropped assignment is
  multiplied by 0 and added at slot ``min(slot, capacity - 1)``;
- ``load`` counts every assignment, kept or not;
- in the combine, ``gates * keep`` is cast to the buffer's dtype before
  the multiply, and each token adds its K terms in order from 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import parallel as par


class RouterStats(NamedTuple):
    load: torch.Tensor        # (E,) fraction of assignments per expert
    aux_loss: torch.Tensor    # load-balance auxiliary loss (Switch-style)
    dropped: torch.Tensor     # fraction of assignments dropped by capacity


def capacity(seq_len: int, num_experts: int, top_k: int, factor: float) -> int:
    cap = int(factor * seq_len * top_k / num_experts)
    return max(8, ((cap + 7) // 8) * 8)


class Routing(NamedTuple):
    """One batch's dispatch plan, each (B, S*K) in token-major order."""
    ids: torch.Tensor         # int64 expert of each assignment
    slot: torch.Tensor        # int64 min(position in its expert, cap - 1)
    keep: torch.Tensor        # bool position < cap
    gates: torch.Tensor       # f32 renormalised gate


def top_k_stable(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first, ties to the lower index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none for ties)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def route(
    x: torch.Tensor, w_router: torch.Tensor, *, top_k: int, cap: int
) -> tuple[Routing, RouterStats]:
    """Routing of x (B, S, d) over the E experts of ``w_router`` (d, E).
    Returns the dispatch plan and the per-sequence stats averaged over B."""
    b, s, _ = x.shape
    num_experts = w_router.shape[1]
    logits = x.float() @ w_router.float()                          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = top_k_stable(probs, top_k)                        # (B, S, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    ids = ids.reshape(b, s * top_k)
    onehot = torch.nn.functional.one_hot(ids, num_experts)         # (B, S*K, E)
    pos = torch.gather(torch.cumsum(onehot, dim=1), 2, ids[..., None])[..., 0] - 1
    keep = pos < cap

    load = onehot.sum(1).float() / (s * top_k)                     # (B, E)
    aux = num_experts * torch.sum(load * probs.mean(1), dim=-1)    # (B,)
    dropped = 1.0 - keep.float().mean(1)                           # (B,)
    plan = Routing(ids=ids, slot=torch.clamp(pos, max=cap - 1), keep=keep,
                   gates=gates.reshape(b, s * top_k))
    return plan, RouterStats(load=load.mean(0), aux_loss=aux.mean(), dropped=dropped.mean())


def _batch_index(plan: Routing) -> torch.Tensor:
    b, n = plan.ids.shape
    return torch.arange(b, device=plan.ids.device)[:, None].expand(b, n)


def dispatch(x: torch.Tensor, plan: Routing, num_experts: int, cap: int) -> torch.Tensor:
    """x (B, S, d) -> the (B, E, cap, d) expert buffers in x's dtype: each
    assignment's token times keep, added at its (expert, slot)."""
    b, s, d = x.shape
    top_k = plan.ids.shape[1] // s
    updates = x.repeat_interleave(top_k, dim=1) * plan.keep[..., None].to(x.dtype)
    buf = torch.zeros((b, num_experts, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((_batch_index(plan), plan.ids, plan.slot), updates, accumulate=True)
    return buf


def expert_ffn(
    buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
    *, partial: bool = False,
) -> torch.Tensor:
    """silu(buf @ wg) * (buf @ wu) @ wd per expert, in the buffers' dtype:
    buf (B, E, C, d), wg/wu (E, d, f), wd (E, f, d) -> (B, E, C, d).
    With ``partial`` (a rank's f-slice) the down product is returned in
    f32, unrounded (``parallel.matmul_f32``), for the sum over the row."""
    b, e, c, d = buf.shape
    flat = buf.transpose(0, 1).reshape(e, b * c, d)                # (E, B*C, d)
    h = torch.nn.functional.silu(torch.bmm(flat, w_gate)) * torch.bmm(flat, w_up)
    y = par.matmul_f32(h, w_down) if partial else torch.bmm(h, w_down)
    return y.reshape(e, b, c, -1).transpose(0, 1)


def combine(y_buf: torch.Tensor, plan: Routing, seq_len: int,
            gate_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The (B, S, d) output from the expert outputs y_buf (B, E, C, d):
    token t adds its K gathered rows, each times bf(gate * keep), in
    order from 0, in y_buf's dtype (bf: rounded to ``gate_dtype``, by
    default y_buf's)."""
    b = y_buf.shape[0]
    top_k = plan.ids.shape[1] // seq_len
    gathered = y_buf[_batch_index(plan), plan.ids, plan.slot]       # (B, S*K, d)
    w = (plan.gates * plan.keep.float()).to(gate_dtype or y_buf.dtype).to(y_buf.dtype)
    terms = (gathered * w[..., None]).reshape(b, seq_len, top_k, -1)
    out = torch.zeros_like(terms[:, :, 0])
    for k in range(top_k):
        out = out + terms[:, :, k]
    return out


def _mean_stats(stats: RouterStats) -> RouterStats:
    """The statistics averaged over the data rows (``pmean``), one
    all-reduce for the three."""
    e = stats.load.shape[0]
    flat = par.mean_over_data(torch.cat([stats.load, stats.aux_loss[None],
                                         stats.dropped[None]]))
    return RouterStats(load=flat[:e], aux_loss=flat[e], dropped=flat[e + 1])


def moe_ffn_parallel(
    x: torch.Tensor,
    w_router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float,
    d_ff: int,
) -> tuple[torch.Tensor, RouterStats]:
    """``moe_ffn`` on a grid: this rank's shards of the weights (``wg``
    and ``wu`` (E, d or d/data, f or f/model), ``wd`` transposed alike,
    the router (d or d/data, E)), x its data row's (B/data, S, d), whole
    on every rank of the row.  ``d_ff`` is the experts' whole hidden dim.
    Returns the row's (B/data, S, d) output and the statistics averaged
    over the data rows.  The path is ``repro``'s (``nn/moe.py``): the
    tensor-parallel one when the row has more than one rank, ``d_ff``
    splits over it and, with FSDP on, d over the data rows; else the
    plain one on whole experts."""
    grid = par.current_grid()
    _, s, d = x.shape
    dtype = x.dtype
    tp = grid.model_parallel
    fsdp_ok = not grid.fsdp or d % grid.data_parallel == 0
    router = par.fsdp(w_router, "router", d)
    num_experts = router.shape[1]
    cap = capacity(s, num_experts, top_k, capacity_factor)
    if tp > 1 and d_ff % tp == 0 and fsdp_ok:
        # Each rank's f-slice; the FSDP rows gathered in f32, as repro's
        # all_gather in its manual region.
        wg, wu, wd = (par.fsdp(w, n, d, torch.float32).to(dtype)
                      for w, n in ((w_gate, "wg"), (w_up, "wu"), (w_down, "wd")))
        plan, stats = route(x, router, top_k=top_k, cap=cap)
        buf = dispatch(par.enter_model(x), plan, num_experts, cap)
        # The partial products stay f32 through the combine and the sum
        # over the row, rounded to x's dtype once (gates rounded as the
        # one-device combine rounds them).
        y = expert_ffn(buf, wg, wu, wd, partial=True)
        plan = plan._replace(gates=par.enter_model(plan.gates))
        out = par.leave_model(combine(y, plan, s, dtype)).to(dtype)
        return out, _mean_stats(stats)
    wg, wu, wd = (par.fsdp(w, n, d) for w, n in ((w_gate, "wg"), (w_up, "wu"), (w_down, "wd")))
    if wg.shape[-1] != d_ff:        # f split but the path is the plain one
        wg, wu, wd = par.gather_model(wg, -1), par.gather_model(wu, -1), par.gather_model(wd, -2)
    plan, stats = route(x, router, top_k=top_k, cap=cap)
    out = combine(expert_ffn(dispatch(x, plan, num_experts, cap), wg, wu, wd), plan, s)
    return out, _mean_stats(stats)


def moe_ffn(
    x: torch.Tensor,
    w_router: torch.Tensor,
    w_gate: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    *,
    top_k: int,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, RouterStats]:
    """x: (B, S, d); w_router: (d, E); w_gate/w_up: (E, d, f); w_down:
    (E, f, d).  Route -> expert FFN -> combine; returns (out (B, S, d),
    the router stats averaged over B)."""
    _, s, _ = x.shape
    num_experts = w_router.shape[1]
    cap = capacity(s, num_experts, top_k, capacity_factor)
    plan, stats = route(x, w_router, top_k=top_k, cap=cap)
    buf = dispatch(x, plan, num_experts, cap)
    y = expert_ffn(buf, w_gate, w_up, w_down)
    return combine(y, plan, s), stats
