"""Consensus averaging over the worker graph, on stacked worker tensors.

Port of ``repro/core/consensus.py``'s gossip primitives, its lossy
schedule hop and its quantizers.  In the port the
M workers are the leading dimension of a tensor, ``(M, ...)``, so the
reference's ``ppermute`` along a mesh axis becomes :func:`ppermute`, a
gather over dim 0: a pair list ``((src, dst), ...)`` that permutes the
workers gives ``out[dst] = x[src]``.

1. ``gossip_average``: B synchronous rounds of x <- H x with a dense
   doubly-stochastic H (the paper-faithful simulation).
2. ``exact_average``: the B -> infinity limit (1/M) sum_m x_m.
3. ``ring_gossip_step``/``ring_gossip_average``: degree-d circular
   gossip as permutation hops.
4. ``schedule_gossip_step``/``schedule_gossip_average``: any
   ``topology.ExchangeSchedule`` (a doubly-stochastic H compiled to
   static ``(permutation, weight)`` steps).  Uniform equal-weight
   schedules run the ring's sum-then-divide hop sequence, so
   ``Gossip(topology=Ring(d), compress=False)`` is bit-identical to
   ``ring_gossip_average``.

The order of operations is the reference's: uniform schedules add the
hops to the worker's own value in schedule order, then divide by the
number of terms; weighted schedules start from ``self_weight * own`` and
add ``w * msg`` in order, with the weights as Python floats (so they
multiply in the tensor's dtype, as the reference's weak-typed scalars
do).  Each permutation's index tensor is built once per device
(:func:`_perm_index`), not per hop.

5. ``lossy_schedule_gossip_step``: one schedule round over links that
   fail independently, each receiver renormalizing its row over the
   survivors; ``quantize_stochastic``/``quantize_nearest``: the k-bit
   wire formats.  Under the reference's ``vmap`` each worker draws with
   its own key and takes its own min/max; here the keys are stacked
   ``(M, 2)`` threefry words (:mod:`repro_torch.prng`) and min/max run
   over every dim but 0.

6. ``faulty_schedule_gossip_step``: one schedule round under a shared
   (M,) up-mask, every dead link's weight rerouted to the receiver's own
   value (the fault model of ``AsyncGossip``); and the screened steps of
   the Byzantine-robust policies, ``trimmed_mean_schedule_gossip_step``,
   ``median_schedule_gossip_step`` and ``clipped_schedule_gossip_step``,
   which first replace every unhealthy (non-finite or dead-link) payload
   by the receiver's own value (``_receive_screened``).  The reference
   runs them per worker under ``vmap``; here a per-worker scalar (a link
   gate, a payload's norm) is an ``(M,)`` or ``(steps, M)`` tensor, and
   a per-worker reduction runs over every dim but the worker dims.  The
   faulty step multiplies by its gates, so a NaN payload reaches its
   receiver even over a dead link, as the reference's does (it is the
   vulnerable baseline); the screened steps select with ``torch.where``.

Every function that moves messages takes a ``ctx`` (a
``policy.ConsensusContext``): its ``ppermute`` and ``gather_steps`` move
them, and its ``local_rows`` cuts a per-worker value made for all M
workers (a link gate, an up-mask) to the workers ``x`` holds.  Without a
``ctx`` ``x`` holds every worker and a hop is a gather over dim 0, as in
the simulated context; under ``MeshBackend`` ``x`` is a rank's block and
the hops cross between ranks.

``make_consensus_fn`` (the legacy batched dense-H factory) is deprecated
and warns, as the reference's does.
"""
from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import exact_div

Tensor = torch.Tensor

#: Wire widths the low-precision gossip link formats support (bits per
#: exchanged scalar, the eq.-15 ``wire_bits`` of a wire_dtype policy).
WIRE_DTYPES = {"float32": 32, "bfloat16": 16, "float16": 16}

#: Spec-grammar shorthands (``--wire-dtype bf16``).
_WIRE_ALIASES = {"f32": "float32", "bf16": "bfloat16", "f16": "float16"}

#: The torch dtype of each canonical wire name.
_TORCH_WIRE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
}


def canonical_wire_dtype(name: str) -> str:
    """Normalize a wire-dtype spec (``f32/bf16/f16`` or the full dtype
    names) to the canonical dtype string, or raise ValueError."""
    full = _WIRE_ALIASES.get(name, name)
    if full not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire dtype {name!r}; expected one of "
            f"{sorted(WIRE_DTYPES)} (or {sorted(_WIRE_ALIASES)})"
        )
    return full


@functools.lru_cache(maxsize=4096)
def _perm_index(perm: tuple, num_workers: int, device: torch.device) -> Tensor:
    """The gather index of one permutation on ``device``: ``out =
    x[index]`` puts ``x[src]`` at ``dst`` for each ``(src, dst)``."""
    srcs = [int(s) for s, _ in perm]
    dsts = [int(d) for _, d in perm]
    if sorted(dsts) != list(range(num_workers)) or sorted(srcs) != sorted(dsts):
        raise ValueError(
            f"ppermute pair list {perm} does not permute {num_workers} workers"
        )
    index = np.empty(num_workers, np.int64)
    index[dsts] = srcs
    return torch.from_numpy(index).to(device)


def ppermute(x: Tensor, perm) -> Tensor:
    """``out[dst] = x[src]`` for each ``(src, dst)`` of ``perm``, a
    permutation of the workers, over dim 0 of the stacked ``x`` (M, ...)."""
    return x.index_select(0, _perm_index(tuple(perm), x.shape[0], x.device))


def gather_steps(x: Tensor, perms) -> Tensor:
    """``ppermute(x, perm)`` for each of ``perms`` at once, ``(steps, M,
    ...)``: one ``index_select`` over dim 0 of the stacked ``x``."""
    index = _perms_index(tuple(perms), x.shape[0], x.device)
    return x.index_select(0, index).view((len(perms),) + tuple(x.shape))


def _hop(x: Tensor, perm, ctx) -> Tensor:
    """One ``ppermute`` through ``ctx`` (a ``policy.ConsensusContext``),
    or over the whole stack ``x`` when there is none."""
    return ppermute(x, perm) if ctx is None else ctx.ppermute(x, perm)


def exact_average(x_workers: Tensor) -> Tensor:
    """(1/M) sum over the leading (worker) dim, broadcast back to all."""
    return x_workers.mean(dim=0, keepdim=True).expand_as(x_workers)


def gossip_average(
    x_workers: Tensor, h: np.ndarray | Tensor, num_rounds: int
) -> Tensor:
    """B synchronous gossip rounds: x^{b+1}_i = sum_j h_ij x^b_j.

    x_workers: (M, ...) tensor, one slice per worker.
    """
    h = torch.as_tensor(h).to(device=x_workers.device, dtype=x_workers.dtype)
    m = x_workers.shape[0]
    flat = x_workers.reshape(m, -1)
    for _ in range(num_rounds):
        flat = h @ flat
    return flat.reshape(x_workers.shape)


def gossip_error(x_workers: Tensor) -> Tensor:
    """Max deviation from the true mean: the consensus quality metric."""
    mean = x_workers.mean(dim=0, keepdim=True)
    return (x_workers - mean).abs().amax()


def _ring_perms(degree: int, num_nodes: int) -> list:
    perms = []
    for k in range(1, degree + 1):
        perms.append(tuple((i, (i + k) % num_nodes) for i in range(num_nodes)))
        perms.append(tuple((i, (i - k) % num_nodes) for i in range(num_nodes)))
    return perms


def ring_gossip_step(x: Tensor, degree: int, num_nodes: int, *, ctx=None) -> Tensor:
    """One degree-d circular gossip round over the stacked ``x``:
    h_ij = 1/(2d+1) equal weights (paper §III), forward then backward
    hop per distance, summed onto the worker's own value.  ``ctx`` (a
    ``policy.ConsensusContext``) moves the messages; without one ``x``
    holds every worker."""
    acc = x
    for perm in _ring_perms(degree, num_nodes):
        acc = acc + _hop(x, perm, ctx)
    return acc / (2 * degree + 1)


def ring_gossip_average(
    x: Tensor, degree: int, num_nodes: int, num_rounds: int, *, ctx=None
) -> Tensor:
    """B rounds of degree-d ring gossip."""
    for _ in range(num_rounds):
        x = ring_gossip_step(x, degree, num_nodes, ctx=ctx)
    return x


def schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    self_value: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One gossip round of an arbitrary doubly-stochastic H, as the
    static permutation steps of a ``topology.ExchangeSchedule``:

        x' = self_weight * self + sum_k weight_k * ppermute(x, perm_k)

    ``self_value`` substitutes another tensor for each worker's OWN
    contribution (peers still receive ``x``).  Uniform equal-weight
    schedules take the sum-then-divide path, which reproduces
    ``ring_gossip_step``'s float ops exactly.

    ``wire_dtype`` (``"bfloat16"``/``"float16"`` or their shorthands)
    narrows the WIRE only: the payload is cast once before the hops,
    every received message is widened back and accumulated in the
    input's precision, and the worker's own contribution never leaves
    full precision.  None, or the input's own dtype, keeps the
    full-width path.  ``ctx`` (a ``policy.ConsensusContext``) moves the
    messages, one ``ppermute`` a hop; without one ``x`` holds every
    worker.
    """
    own = x if self_value is None else self_value
    narrow = (
        None if wire_dtype is None
        else _TORCH_WIRE_DTYPES[canonical_wire_dtype(wire_dtype)]
    )
    if narrow is not None and narrow != x.dtype:
        wire = x.to(narrow)
        # Narrow links always take the weighted form: the sum-then-divide
        # shortcut would accumulate at wire precision.
        acc = schedule.self_weight * own
        for perm, w in zip(schedule.perms, schedule.weights):
            acc = acc + w * _hop(wire, perm, ctx).to(own.dtype)
        return acc
    if schedule.uniform:
        acc = own
        for perm in schedule.perms:
            acc = acc + _hop(x, perm, ctx)
        return acc / (len(schedule.perms) + 1)
    acc = schedule.self_weight * own
    for perm, w in zip(schedule.perms, schedule.weights):
        acc = acc + w * _hop(x, perm, ctx)
    return acc


def schedule_gossip_average(
    x: Tensor,
    schedule,
    num_rounds: int,
    *,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """B rounds of exchange-schedule gossip."""
    for _ in range(num_rounds):
        x = schedule_gossip_step(x, schedule, wire_dtype=wire_dtype, ctx=ctx)
    return x


@functools.lru_cache(maxsize=1024)
def _perms_index(perms: tuple, num_workers: int, device: torch.device) -> Tensor:
    """The gather index of several permutations at once: ``x[index]``
    stacks ``ppermute(x, perm)`` for each perm along dim 0."""
    return torch.cat([_perm_index(p, num_workers, device) for p in perms])


def _worker_shape(x: Tensor) -> tuple:
    """Shape that broadcasts a per-worker ``(M,)`` value over ``x``."""
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def lossy_link_weights(schedule, drop_prob: float, key) -> tuple[np.ndarray, np.ndarray]:
    """The link draws of one lossy round, on the host: each worker splits
    its key (``key``, (M, 2) threefry words) into one subkey per schedule
    step and keeps step i alive with probability ``1 - drop_prob``.
    Returns ``coef`` (steps, M), ``alive * weight`` in f32, and ``wsum``
    (M,), the surviving row sum ``self_weight + sum_i coef_i`` added in
    step order in f32, as the reference accumulates them."""
    perms = schedule.perms
    keys = prng.split(prng.key_data(key), max(len(perms), 1))        # (M, P, 2)
    alive = prng.bernoulli(keys, 1.0 - drop_prob, ()).astype(np.float32)
    coef = np.stack(
        [alive[:, i] * np.float32(w) for i, w in enumerate(schedule.weights)]
    ) if perms else np.zeros((0, alive.shape[0]), np.float32)
    wsum = np.full(alive.shape[0], np.float32(schedule.self_weight), np.float32)
    for c in coef:
        wsum = wsum + c
    return coef, wsum


def lossy_gossip_apply(
    x: Tensor,
    schedule,
    coef: Tensor,
    wsum: Tensor,
    *,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One lossy round with its link draws given (:func:`lossy_link_weights`,
    as tensors on ``x``'s device, for every worker):

        x' = (self_weight * x + sum_i coef_i * ppermute(wire, perm_i)) / wsum

    Every step's message is gathered at once (``ctx.gather_steps``, or
    one ``index_select`` over the whole stack without a ``ctx``) and
    scaled in one product; the products are added in step order."""
    narrow = (
        None if wire_dtype is None
        else _TORCH_WIRE_DTYPES[canonical_wire_dtype(wire_dtype)]
    )
    if ctx is not None:
        coef, wsum = ctx.local_rows(coef, 1), ctx.local_rows(wsum)
    acc = schedule.self_weight * x
    if schedule.perms:
        wire = x if narrow is None else x.to(narrow)
        steps = len(schedule.perms)
        msgs = _gather_steps(wire, schedule, x.dtype, ctx)
        scaled = coef.reshape((steps,) + _worker_shape(x)) * msgs
        for i in range(steps):
            acc = acc + scaled[i]
    return acc / wsum.view(_worker_shape(x))


def lossy_schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    drop_prob: float,
    key,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One exchange-schedule gossip round over a lossy network: each
    incoming step fails independently with probability ``drop_prob`` and
    the receiver renormalizes its mixing row over the surviving weights
    (the self term never drops; ``drop_prob=0`` reduces to
    :func:`schedule_gossip_step` up to float association).  ``key`` is
    the stacked per-worker keys, (M, 2) (each node observes its own link
    failures); the draws are made on the host.  ``wire_dtype`` narrows
    the link payloads as in :func:`schedule_gossip_step`; with a ``ctx``
    ``key`` is every worker's."""
    coef, wsum = lossy_link_weights(schedule, drop_prob, key)
    coef = torch.from_numpy(coef).to(x.device)
    wsum = torch.from_numpy(wsum).to(x.device)
    return lossy_gossip_apply(x, schedule, coef, wsum, wire_dtype=wire_dtype, ctx=ctx)


def _narrow_dtype(wire_dtype: str | None):
    return (
        None if wire_dtype is None
        else _TORCH_WIRE_DTYPES[canonical_wire_dtype(wire_dtype)]
    )


def _gather_steps(wire: Tensor, schedule, dtype, ctx=None) -> Tensor:
    """Every step's received message at once, ``(steps, M, ...)``: one
    ``index_select`` over the worker dim (``ctx.gather_steps`` with a
    ``ctx``), widened back to ``dtype``."""
    if not schedule.perms:
        return wire.new_empty((0,) + tuple(wire.shape), dtype=dtype)
    msgs = gather_steps(wire, schedule.perms) if ctx is None else ctx.gather_steps(
        wire, schedule.perms)
    return msgs.to(dtype)


def _per_step(v: Tensor, x: Tensor) -> Tensor:
    """A ``(steps, M)`` per-link value shaped to broadcast over the
    ``(steps, M, ...)`` messages of ``x``."""
    return v.view(tuple(v.shape) + (1,) * (x.ndim - 1))


def _sum_per_message(t: Tensor, lead: int) -> Tensor:
    """Sum over every dim after the first ``lead`` (one worker's message)."""
    return t.flatten(lead).sum(dim=-1) if t.ndim > lead else t


def faulty_link_weights(schedule, alive: Tensor) -> tuple[Tensor, Tensor]:
    """The link gates of one faulty round from the shared (M,) up-mask
    ``alive`` (in the message's dtype): a step's message survives only
    when its sender and its receiver are both up, ``g = alive[me] *
    alive[src]``.  Returns ``coef`` (steps, M), ``w * g``, and ``lost``
    (M,), ``sum_k w_k (1 - g_k)`` added in step order, as the reference
    accumulates them, on ``alive``'s device."""
    m = schedule.num_workers
    coefs = []
    lost = torch.zeros(m, dtype=alive.dtype, device=alive.device)
    for perm, w in zip(schedule.perms, schedule.weights):
        g = alive * alive.index_select(0, _perm_index(tuple(perm), m, alive.device))
        coefs.append(w * g)
        lost = lost + w * (1.0 - g)
    coef = (
        torch.stack(coefs) if coefs
        else torch.zeros((0, m), dtype=alive.dtype, device=alive.device)
    )
    return coef, lost


def faulty_gossip_apply(
    x: Tensor,
    schedule,
    coef: Tensor,
    lost: Tensor,
    *,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One faulty round with its link gates given
    (:func:`faulty_link_weights`, on ``x``'s device, for every worker):

        x' = self_weight * x + sum_k coef_k * recv_k + lost * x

    the products added in step order.  ``transmit`` is what peers
    receive; each worker's own term is the fresh ``x``.  ``ctx`` moves
    the messages and says which workers ``x`` holds."""
    narrow = _narrow_dtype(wire_dtype)
    if ctx is not None:
        coef, lost = ctx.local_rows(coef, 1), ctx.local_rows(lost)
    out = x if transmit is None else transmit
    acc = schedule.self_weight * x
    if schedule.perms:
        wire = out if narrow is None else out.to(narrow)
        scaled = _per_step(coef, x) * _gather_steps(wire, schedule, x.dtype, ctx)
        for i in range(len(schedule.perms)):
            acc = acc + scaled[i]
    return acc + lost.view(_worker_shape(x)) * x


def faulty_schedule_gossip_step(
    x: Tensor,
    schedule,
    alive,
    *,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One exchange-schedule gossip round under a shared fault mask.

    ``alive`` is the (M,) 0/1 vector of which workers are up this round
    (``policy.FaultModel.alive_mask``).  A step's message survives only
    when both endpoints are up (g = alive[me] * alive[src]); the weight
    of every dead link is rerouted to the receiver's own value:

        x' = self_w * x + sum_k w_k [g_k * recv_k + (1 - g_k) * x]

    so every realized row sums to 1 whatever the draw, and a down worker
    holds its value.  On an inverse-closed schedule
    (``topology.is_inverse_closed``) the gate kills the (i -> j) and
    (j -> i) weights together, so the mean over the up workers is kept.

    ``transmit`` substitutes the value peers RECEIVE (a straggler's stale
    iterate, an attacker's payload); each worker's own contribution is
    the fresh ``x``.  The gate multiplies the message, so a NaN payload
    reaches its receiver even over a dead link, as in the reference.
    ``wire_dtype`` narrows the link payload as in
    :func:`schedule_gossip_step`.
    """
    alive = torch.as_tensor(alive).to(device=x.device, dtype=x.dtype)
    coef, lost = faulty_link_weights(schedule, alive)
    return faulty_gossip_apply(
        x, schedule, coef, lost, transmit=transmit, wire_dtype=wire_dtype, ctx=ctx,
    )


def _receive_screened(
    x: Tensor,
    schedule,
    alive: Tensor | None,
    *,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
):
    """Gather one payload per schedule step for every worker, screening
    each incoming message before it can touch an aggregate.

    Returns ``(payloads, oks, weights, self_weight)``: ``payloads``
    (steps, M, ...) holds step k's received message with the whole
    message REPLACED by the receiver's own ``x`` when the link is down
    (both endpoints must be up in ``alive``) or the message holds any
    non-finite entry; ``oks`` (steps, M) is that health gate (True = the
    raw message survived).  A NaN-bombing peer thus degrades into the
    dead-link reroute of :func:`faulty_schedule_gossip_step`, never a
    poisoned mean; the gates let order-statistic aggregators keep the
    rerouted links out of their neighborhood-scale estimates.

    ``transmit`` substitutes what peers receive; the receiver's own ``x``
    stays fresh.  The gate selects with ``torch.where``, so non-finite
    values never enter a multiply.  ``alive`` is every worker's; ``ctx``
    moves the messages and says which workers ``x`` holds.
    """
    narrow = _narrow_dtype(wire_dtype)
    out = x if transmit is None else transmit
    wire = out if narrow is None else out.to(narrow)
    steps, m = len(schedule.perms), schedule.num_workers
    msgs = _gather_steps(wire, schedule, x.dtype, ctx)
    ok = torch.isfinite(msgs)
    ok = ok.flatten(2).all(dim=-1) if ok.ndim > 2 else ok
    if alive is not None and steps:
        alive = alive.to(x.dtype)
        index = _perms_index(tuple(schedule.perms), m, x.device)
        up = (alive * alive.index_select(0, index).view(steps, m)) > 0.5
        ok = ok & (up if ctx is None else ctx.local_rows(up, 1))
    payloads = torch.where(_per_step(ok, x), msgs, x)
    return payloads, ok, schedule.weights, schedule.self_weight


#: Neighborhood-scale factor of the trimmed-mean outlier screen: a link
#: is trimmable when its payload's distance from the receiver exceeds
#: this multiple of the median neighborhood distance.  Below 1 the screen
#: trims the top-f links essentially unconditionally (mis-flagging honest
#: extremes); large values only catch payloads far outside the honest
#: spread.  1.5 catches a signflip attacker (whose payload sits ~2||x||
#: from every honest receiver) while honest distances stay within it.
TRIM_SCREEN_FACTOR = 1.5


def _midpoint(lo: Tensor, hi: Tensor) -> Tensor:
    """The reference's median of two order statistics: (lo + hi) * 0.5
    (``jnp.median``'s ``midpoint`` method; one middle value gives
    (a + a) * 0.5).  ``torch.median`` would return the lower one, and
    ``torch.quantile`` rounds ``lo + (hi - lo) * 0.5`` differently."""
    return (lo + hi) * 0.5


def _median0(stack: Tensor) -> Tensor:
    """``jnp.median(stack, axis=0)``: sort along dim 0 and take the
    midpoint of the middle pair; NaN wherever the column holds one."""
    n = stack.shape[0]
    srt = torch.sort(stack, dim=0).values
    med = _midpoint(srt[(n - 1) // 2], srt[n // 2])
    return torch.where(torch.isnan(stack).any(dim=0), torch.nan, med)


def _nanmedian0(v: Tensor) -> Tensor:
    """``jnp.nanmedian(v, axis=0)``: the midpoint of the middle pair of
    each column's non-NaN values (sorting puts NaN last); NaN where a
    column has none."""
    srt = torch.sort(v, dim=0).values
    count = (~torch.isnan(v)).sum(dim=0, keepdim=True)
    lo = torch.div(count - 1, 2, rounding_mode="floor").clamp_min(0)
    hi = torch.div(count, 2, rounding_mode="floor")
    return _midpoint(srt.gather(0, lo), srt.gather(0, hi))[0]


def trimmed_mean_schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    trim: int,
    alive: Tensor | None = None,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One robust gossip round: screened trimmed-mean aggregation.

    Each of the ``trim`` most-deviant payloads (Frobenius distance from
    the receiver's own value) is rerouted to the diagonal, but only when
    it stands out from the neighborhood scale,

        d_k > TRIM_SCREEN_FACTOR * median({d_j}) + 1e-6 * (1 + ||x||),

    so honest links mix with their exact gossip weights and a Byzantine
    payload beyond the honest spread loses its whole link weight.  A
    screened (rerouted) link ranks as most deviant and stays out of the
    median.  Ranks break ties by step order (a stable sort), as the
    reference's ``argsort`` does.  Requires a uniform equal-weight
    schedule.
    """
    if not schedule.uniform:
        raise ValueError(
            "trimmed-mean gossip needs a uniform equal-weight schedule"
        )
    payloads, ok, _, _ = _receive_screened(
        x, schedule, alive, transmit=transmit, wire_dtype=wire_dtype, ctx=ctx,
    )
    steps = payloads.shape[0]
    s = steps + 1
    if not 0 <= 2 * trim < s:
        raise ValueError(
            f"trim={trim} needs 2*trim < neighborhood size {s}"
        )
    acc = x
    if trim == 0:
        for k in range(steps):
            acc = acc + payloads[k]
        return exact_div(acc, s)
    raw = torch.sqrt(_sum_per_message(torch.square(payloads - x), 2))
    dists = torch.where(ok, raw, torch.inf)
    med = _nanmedian0(torch.where(ok, raw, torch.nan))
    floor = 1e-6 * (1.0 + torch.sqrt(_sum_per_message(torch.square(x), 1)))
    thresh = TRIM_SCREEN_FACTOR * med + floor
    # rank 0 = most deviant; flag the `trim` most deviant links, but only
    # those beyond the neighborhood-scale threshold.
    ranks = torch.argsort(torch.argsort(-dists, dim=0, stable=True), dim=0)
    flags = _per_step((ranks < trim) & (dists > thresh), x)
    for k in range(steps):
        acc = acc + torch.where(flags[k], x, payloads[k])
    return exact_div(acc, s)


def median_schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    alive: Tensor | None = None,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One robust gossip round: coordinate-wise median of the screened
    neighborhood stack (own value first), the maximal-breakdown member
    of the trimmed-mean family.  An even stack takes the midpoint of its
    middle pair, as ``jnp.median`` does.  Uniform schedules only."""
    if not schedule.uniform:
        raise ValueError("median gossip needs a uniform equal-weight schedule")
    payloads, _, _, _ = _receive_screened(
        x, schedule, alive, transmit=transmit, wire_dtype=wire_dtype, ctx=ctx,
    )
    return _median0(torch.cat([x[None], payloads], dim=0))


def clipped_schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    tau: float,
    alive: Tensor | None = None,
    transmit: Tensor | None = None,
    wire_dtype: str | None = None,
    ctx=None,
) -> Tensor:
    """One robust gossip round with norm-clipped incoming payloads
    (centered clipping): each screened payload's deviation from self is
    shrunk onto the Frobenius ball of radius ``tau`` before the weighted
    accumulation,

        recv_k' = x + min(1, tau / ||recv_k - x||) (recv_k - x)

    so one attacker moves its receiver by at most w_k * tau a round.
    Payloads within the ball pass through untouched (selected, not
    recomputed).  Works on any schedule (weights are respected)."""
    if tau <= 0.0:
        raise ValueError(f"clip radius tau must be > 0, got {tau}")
    payloads, _, weights, self_weight = _receive_screened(
        x, schedule, alive, transmit=transmit, wire_dtype=wire_dtype, ctx=ctx,
    )
    acc = self_weight * x
    if weights:
        delta = payloads - x
        norm = torch.sqrt(_sum_per_message(delta * delta, 2))
        # tau / norm as a tensor division: ``python_scalar / tensor`` is a
        # reciprocal times the scalar in torch, which rounds differently.
        scale = torch.full_like(norm, tau) / norm.clamp_min(1e-30)
        clipped = x + _per_step(scale, x) * delta
        kept = torch.where(_per_step(norm <= tau, x), payloads, clipped)
        for k, w in enumerate(weights):
            acc = acc + w * kept[k]
    return acc


def _range_over_workers(x: Tensor):
    dims = tuple(range(1, x.ndim))
    return x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)


def quantize_stochastic(x: Tensor, bits: int, key) -> Tensor:
    """Unbiased per-worker stochastic-rounding quantization to 2^bits
    levels over each worker's dynamic range: E[q(x)] = x.  ``x`` is
    stacked (M, ...); ``key`` the per-worker keys, (M, 2) threefry words
    (numpy or a tensor), each drawing ``bernoulli(key_m, prob_m,
    x.shape[1:])`` on ``x``'s device, as the reference's ``vmap`` does."""
    levels = 2 ** bits - 1
    lo, hi = _range_over_workers(x)
    scale = exact_div(torch.clamp_min(hi - lo, 1e-12), levels)
    t = (x - lo) / scale
    floor = torch.floor(t)
    up = prng.bernoulli(key, t - floor, tuple(x.shape[1:]), device=x.device)
    return lo + (floor + up.to(x.dtype)) * scale


def quantize_nearest(x: Tensor, bits: int) -> Tensor:
    """Deterministic round-to-nearest variant (biased, zero variance),
    per worker of the stacked ``x``."""
    levels = 2 ** bits - 1
    lo, hi = _range_over_workers(x)
    scale = exact_div(torch.clamp_min(hi - lo, 1e-12), levels)
    return lo + torch.round((x - lo) / scale) * scale


class _DenseGossip:
    """``gossip_average`` with a fixed H and B, H moved to each device
    and dtype once."""

    def __init__(self, h: np.ndarray, num_rounds: int):
        self.h = np.asarray(h, dtype=np.float64)
        self.num_rounds = int(num_rounds)
        self._placed: dict = {}

    def __call__(self, x_workers: Tensor) -> Tensor:
        key = (x_workers.device, x_workers.dtype)
        if key not in self._placed:
            self._placed[key] = torch.as_tensor(self.h).to(
                device=x_workers.device, dtype=x_workers.dtype
            )
        return gossip_average(x_workers, self._placed[key], self.num_rounds)


def make_consensus_fn(
    mode: str,
    *,
    h: np.ndarray | None = None,
    num_rounds: int = 1,
):
    """Factory for a worker-dim consensus function f: (M, ...) -> (M, ...).

    mode = 'exact'  : true mean (== one all-reduce)
    mode = 'gossip' : B rounds of x <- Hx (paper-faithful simulation)

    .. deprecated::
        Kept for the batched dense-H simulation path.  New code should
        pass a ``repro_torch.core.policy`` ConsensusPolicy to a
        ``ConsensusBackend``: the same mixing expressed as peer exchanges.
    """
    warnings.warn(
        "make_consensus_fn is deprecated; pass a ConsensusPolicy "
        "(repro_torch.core.policy) to a ConsensusBackend instead",
        DeprecationWarning,
        stacklevel=2,
    )
    if mode == "exact":
        return exact_average
    if mode == "gossip":
        if h is None:
            raise ValueError("gossip mode requires a mixing matrix h")
        return _DenseGossip(h, num_rounds)
    raise ValueError(f"unknown consensus mode {mode!r}")
