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

``make_consensus_fn`` (the legacy batched dense-H factory) is deprecated
and warns, as the reference's does.  The faulty and robust primitives
wait for ROADMAP Queue 1 item 4.
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


def ring_gossip_step(x: Tensor, degree: int, num_nodes: int) -> Tensor:
    """One degree-d circular gossip round over the stacked ``x``:
    h_ij = 1/(2d+1) equal weights (paper §III), forward then backward
    hop per distance, summed onto the worker's own value."""
    acc = x
    for perm in _ring_perms(degree, num_nodes):
        acc = acc + ppermute(x, perm)
    return acc / (2 * degree + 1)


def ring_gossip_average(
    x: Tensor, degree: int, num_nodes: int, num_rounds: int
) -> Tensor:
    """B rounds of degree-d ring gossip."""
    for _ in range(num_rounds):
        x = ring_gossip_step(x, degree, num_nodes)
    return x


def schedule_gossip_step(
    x: Tensor,
    schedule,
    *,
    self_value: Tensor | None = None,
    wire_dtype: str | None = None,
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
    full-width path.
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
            acc = acc + w * ppermute(wire, perm).to(own.dtype)
        return acc
    if schedule.uniform:
        acc = own
        for perm in schedule.perms:
            acc = acc + ppermute(x, perm)
        return acc / (len(schedule.perms) + 1)
    acc = schedule.self_weight * own
    for perm, w in zip(schedule.perms, schedule.weights):
        acc = acc + w * ppermute(x, perm)
    return acc


def schedule_gossip_average(
    x: Tensor,
    schedule,
    num_rounds: int,
    *,
    wire_dtype: str | None = None,
) -> Tensor:
    """B rounds of exchange-schedule gossip."""
    for _ in range(num_rounds):
        x = schedule_gossip_step(x, schedule, wire_dtype=wire_dtype)
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
) -> Tensor:
    """One lossy round with its link draws given (:func:`lossy_link_weights`,
    as tensors on ``x``'s device):

        x' = (self_weight * x + sum_i coef_i * ppermute(wire, perm_i)) / wsum

    Every step's message is gathered in one ``index_select`` and scaled
    in one product; the products are added in step order."""
    narrow = (
        None if wire_dtype is None
        else _TORCH_WIRE_DTYPES[canonical_wire_dtype(wire_dtype)]
    )
    acc = schedule.self_weight * x
    if schedule.perms:
        wire = x if narrow is None else x.to(narrow)
        steps = len(schedule.perms)
        index = _perms_index(tuple(schedule.perms), x.shape[0], x.device)
        msgs = wire.index_select(0, index).view((steps,) + tuple(x.shape))
        if narrow is not None:
            msgs = msgs.to(x.dtype)
        scaled = coef.view((steps,) + _worker_shape(x)) * msgs
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
) -> Tensor:
    """One exchange-schedule gossip round over a lossy network: each
    incoming step fails independently with probability ``drop_prob`` and
    the receiver renormalizes its mixing row over the surviving weights
    (the self term never drops; ``drop_prob=0`` reduces to
    :func:`schedule_gossip_step` up to float association).  ``key`` is
    the stacked per-worker keys, (M, 2) (each node observes its own link
    failures); the draws are made on the host.  ``wire_dtype`` narrows
    the link payloads as in :func:`schedule_gossip_step`."""
    coef, wsum = lossy_link_weights(schedule, drop_prob, key)
    coef = torch.from_numpy(coef).to(x.device)
    wsum = torch.from_numpy(wsum).to(x.device)
    return lossy_gossip_apply(x, schedule, coef, wsum, wire_dtype=wire_dtype)


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
