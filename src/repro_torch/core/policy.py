"""ConsensusPolicy: one strategy object per way of reaching consensus.

Port of ``repro/core/policy.py``: the :class:`ConsensusContext`
collectives, the :class:`ConsensusPolicy` protocol with its eq.-15
accounting, :class:`ExactMean`, the paper's gossip (:class:`Gossip` over
any :mod:`repro_torch.core.topology` graph, and :func:`RingGossip`, its
circular alias), the non-ideal links of the paper's §IV
(:class:`QuantizedGossip`, :class:`LossyGossip`, :class:`StaleMixing`),
asynchronous gossip under a seeded fault model (:class:`FaultModel`,
:class:`AsyncGossip`), the Byzantine-robust policies
(:class:`TrimmedMeanGossip`, :class:`MedianGossip`,
:class:`ClippedGossip`) and the spec grammar (:func:`parse_policy`).

The paper's Algorithm 1 is parameterized by *how* the workers average;
everything else is invariant.  A policy's ``mix(x, state, ctx)`` runs
inside the worker program and communicates only through ``ctx``.  In the
port the workers are the leading dimension of a tensor: all M of them
under :class:`ConsensusContext` (``SimulatedBackend``), where a
collective is a reduction over dim 0 whose result every worker sees and
a ``ppermute`` hop is a gather over dim 0, or one rank's block of them
under :class:`MeshContext` (``MeshBackend``), where the reductions and
the hops cross between ranks.

==================================  ==============================  ==========
policy                              exchanges/round                 wire bits
==================================  ==============================  ==========
``ExactMean()``                     1 (one all-reduce)              32
``Gossip(rounds, topology)``        rounds * topology edges         32/16
``RingGossip(rounds, degree)``      2 * degree * rounds             32/16
``QuantizedGossip(bits, ...)``      1 (or rounds * edges)           ``bits``
``LossyGossip(drop_prob, ...)``     rounds * topology edges         32/16
``StaleMixing(delay, ...)``         1 (or topology edges)           32/16
``AsyncGossip(rounds, interval)``   rounds * edges / interval       32/16
``TrimmedMeanGossip(f, ...)``       rounds * topology edges         32/16
``MedianGossip(rounds, ...)``       rounds * topology edges         32/16
``ClippedGossip(tau, ...)``         rounds * topology edges         32/16
==================================  ==============================  ==========

``Gossip`` compiles its B rounds into ONE H^B mix by default
(``compress=True``; :meth:`repro_torch.core.topology.Topology.power_schedule`),
where that schedule is shallower than B serial rounds, and takes
``wire_dtype=`` (f32 / bf16 / f16 link payloads accumulated in full
precision).  :class:`FaultModel` injects seeded omission faults (drops,
crash-stops, stragglers) and corruption faults (``byzantine=`` workers
sending ``signflip | scale:c | noise:s | nanbomb | replay:d`` payloads);
``AsyncGossip`` trusts what it receives (the vulnerable baseline), the
robust policies screen every payload for non-finite values and bound
what ``f`` attackers per neighborhood can do.

Policies are frozen dataclasses: hashable (they key the backend's
program record), compare by value, and hold only static configuration.
Randomized policies fold a static integer ``seed`` into threefry keys
(:mod:`repro_torch.prng`, ``jax.random``'s words), so they draw
``repro``'s numbers.  No key depends on the data: key chains, link draws
and fault masks are computed on the host in numpy and memoized (every
layer's ADMM starts the same chain), so only the bulk stochastic-rounding
bits are drawn on the device, in one batched pass a mix.  A state that
counts mixes (``AsyncGossip``, the robust policies) keeps the count as a
host integer for the same reason.
"""
from __future__ import annotations

import abc
import functools
from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import exact_div, to_device
from repro_torch.core import consensus as consensus_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.consensus import (  # noqa: F401  (re-exported, as the
    quantize_nearest,                     # reference's module does)
    quantize_stochastic,
)
from repro_torch.core.topology import Ring, Topology, parse_topology

Tensor = torch.Tensor


@dataclass(frozen=True)
class ConsensusContext:
    """Every data-moving primitive a policy may use inside the worker
    program.  The reductions reduce over the worker dimension (dim 0) of
    a stacked tensor and hand every worker the result, stacked again;
    ``ppermute`` and ``gather_steps`` move each worker's slice to another
    worker.  This context holds all M workers in one ``(M, ...)`` stack
    (:class:`SimulatedBackend`'s); :class:`MeshContext` holds one rank's
    block of them.  ``num_workers`` is always the global M, and a value
    made for every worker on the host (a fault mask, a link gate, a
    per-worker key) is cut to the held workers with :meth:`local_rows`."""

    num_workers: int

    def pmean(self, x: Tensor) -> Tensor:
        return x.mean(dim=0, keepdim=True).expand_as(x)

    def psum(self, x: Tensor) -> Tensor:
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def pmax(self, x: Tensor) -> Tensor:
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def total(self, v: Tensor) -> Tensor:
        """The sum of a per-worker value ``v`` over every worker, as a 0-d
        tensor."""
        return v.sum()

    def ppermute(self, x: Tensor, perm) -> Tensor:
        """``out[dst] = x[src]`` for each ``(src, dst)`` pair of ``perm``,
        a permutation of the workers."""
        return consensus_lib.ppermute(x, perm)

    def gather_steps(self, x: Tensor, perms) -> Tensor:
        """Every permutation's received message at once, ``(steps,
        m_local, ...)``: ``ppermute(x, perm)`` for each of ``perms``."""
        return consensus_lib.gather_steps(x, perms)

    def local_rows(self, t, dim: int = 0):
        """The held workers' rows of a global per-worker value (``(M,
        ...)``, or ``(steps, M)`` with ``dim=1``); all of them here."""
        return t

    def worker_index(self, device: torch.device | str | None = None) -> Tensor:
        return torch.arange(self.num_workers, device=device)


@functools.lru_cache(maxsize=1024)
def _mesh_plan(perms: tuple, num_workers: int, rank: int, ranks: int, device: torch.device):
    """A rank's :func:`repro_torch.launch.mesh.exchange_plan` for
    ``perms``, with the pool index on ``device``."""
    from repro_torch.launch.mesh import exchange_plan

    index, recv_rows, send_rows = exchange_plan(perms, num_workers, rank, ranks)
    sends = {p: torch.from_numpy(np.asarray(r, np.int64)).to(device)
             for p, r in send_rows.items()}
    return torch.from_numpy(index).to(device), recv_rows, sends


@dataclass(frozen=True, eq=False)
class MeshContext(ConsensusContext):
    """One rank's view of the workers under ``MeshBackend``: it holds the
    contiguous block ``rows`` of M/W workers as an ``(M/W, ...)`` stack,
    and only messages and reductions cross to the other ranks, through
    ``transport`` (:class:`repro_torch.launch.mesh.Transport`).

    A reduction sums (or maxes) the held workers, then reduces across the
    ranks in one ``all_reduce``; the mean divides by the global M.  A hop
    moves the rows whose source and destination share this rank with a
    local ``index_select`` and the others point to point, only along the
    permutation's cross-rank pairs; eq. 15 still counts every worker's
    exchanges, the wire carries only the cross-rank part."""

    rank: int = 0
    ranks: int = 1
    transport: Any = None

    @property
    def local_workers(self) -> int:
        return self.num_workers // self.ranks

    @property
    def rows(self) -> slice:
        lo = self.rank * self.local_workers
        return slice(lo, lo + self.local_workers)

    def pmean(self, x: Tensor) -> Tensor:
        total = self.transport.all_reduce(x.sum(dim=0, keepdim=True))
        return exact_div(total, self.num_workers).expand_as(x)

    def psum(self, x: Tensor) -> Tensor:
        return self.transport.all_reduce(x.sum(dim=0, keepdim=True)).expand_as(x)

    def pmax(self, x: Tensor) -> Tensor:
        return self.transport.all_reduce(x.amax(dim=0, keepdim=True), "max").expand_as(x)

    def total(self, v: Tensor) -> Tensor:
        return self.transport.all_reduce(v.sum().reshape(1))[0]

    def ppermute(self, x: Tensor, perm) -> Tensor:
        return self.gather_steps(x, (perm,))[0]

    def gather_steps(self, x: Tensor, perms) -> Tensor:
        perms = tuple(tuple(p) for p in perms)
        index, recv_rows, sends = _mesh_plan(
            perms, self.num_workers, self.rank, self.ranks, x.device
        )
        msgs = {p: x.index_select(0, rows) for p, rows in sends.items()}
        pool = x
        if recv_rows or msgs:
            got = self.transport.exchange(msgs, recv_rows, like=x)
            pool = torch.cat([x] + [got[p] for p in sorted(got)], dim=0)
        nbytes = sum(m.numel() * m.element_size() for m in msgs.values())
        self.transport.count("collective-permute", len(perms), nbytes, x.dtype)
        return pool.index_select(0, index).view((len(perms),) + tuple(x.shape))

    def local_rows(self, t, dim: int = 0):
        return t[(slice(None),) * dim + (self.rows,)]

    def worker_index(self, device: torch.device | str | None = None) -> Tensor:
        return torch.arange(self.rows.start, self.rows.stop, device=device)


def _cycle_exchanges(
    topology: Topology, rounds: int, num_workers: int | None
) -> int:
    """Eq.-15 peer messages for B gossip rounds over a (possibly
    time-varying) topology: round b talks on cycle[b % L]'s edges."""
    cycle = topology.cycle()
    return sum(
        cycle[b % len(cycle)].edges_per_node(num_workers)
        for b in range(rounds)
    )


def _cycle_schedules(topology: Topology, ctx: "ConsensusContext") -> list:
    """Per-round exchange schedules; round b uses schedules[b % L]
    (memoized: irregular graphs pay a Birkhoff decomposition per
    schedule construction)."""
    return [
        topology_lib.cached_exchange_schedule(t, ctx.num_workers)
        for t in topology.cycle()
    ]


class ConsensusPolicy(abc.ABC):
    """Strategy object for the paper's graph-average primitive.

    Implementations must be hashable value objects (frozen dataclasses):
    they key the backend's program record, so two equal policies share
    one program.
    """

    #: Short mode string (the ``--consensus`` spelling).
    mode_name: str = "policy"

    #: Bits per scalar actually put on the wire (eq.-15 byte accounting).
    wire_bits: int = 32

    @property
    @abc.abstractmethod
    def exchanges_per_round(self) -> int:
        """Peer messages each worker sends per ``mix`` call (eq. 15's B)."""

    def exchanges_for(self, num_workers: int | None) -> int:
        """M-aware exchange count, the accounting entry point backends and
        trainers use (topology degree can depend on M)."""
        return self.exchanges_per_round

    @property
    def communication_interval(self) -> int:
        """Mix every N-th consensus call; 1 for every synchronous policy."""
        return 1

    @property
    def is_exact(self) -> bool:
        """True if ``mix`` returns the true mean on every worker, which
        lets callers skip consensus-error collectives."""
        return False

    def validate(self, num_workers: int) -> None:
        """Raise ValueError if this policy cannot run on M workers."""

    def init_state(self, x: Tensor, ctx: ConsensusContext) -> Any:
        """Per-worker state threaded through the ADMM iterations (PRNG
        keys, staleness buffers); stateless policies return ()."""
        return ()

    @abc.abstractmethod
    def mix(self, x: Tensor, state: Any, ctx: ConsensusContext) -> Tuple[Tensor, Any]:
        """One consensus round: every worker's estimate of the graph mean
        of the stacked ``x``, and the advanced state."""

    def one_shot(self, x: Tensor, ctx: ConsensusContext) -> Tensor:
        """Single mix from a fresh state."""
        out, _ = self.mix(x, self.init_state(x, ctx), ctx)
        return out

    def comm_scalars(
        self, *, scalars: int, num_consensus: int,
        num_workers: int | None = None,
    ) -> int:
        """Eq.-15 scalars per worker on the wire: ``scalars`` floats per
        exchange, ``exchanges_for(M)`` exchanges per consensus call,
        ``num_consensus`` consensus calls."""
        return scalars * self.exchanges_for(num_workers) * num_consensus

    def wire_bytes(
        self, *, scalars: int, num_consensus: int,
        num_workers: int | None = None,
    ) -> int:
        """Eq.-15 wire bytes per worker: :meth:`comm_scalars` at this
        policy's link width."""
        return (
            self.comm_scalars(
                scalars=scalars, num_consensus=num_consensus,
                num_workers=num_workers,
            ) * self.wire_bits // 8
        )

    def describe(self) -> str:
        return repr(self)


@dataclass(frozen=True)
class ExactMean(ConsensusPolicy):
    """One all-reduce: the B -> infinity limit of gossip (paper §III)."""

    mode_name = "exact"

    @property
    def exchanges_per_round(self) -> int:
        return 1

    @property
    def is_exact(self) -> bool:
        return True

    def mix(self, x, state, ctx):
        return ctx.pmean(x), state


# -------------------------------------------------------------- gossip

@dataclass(frozen=True)
class Gossip(ConsensusPolicy):
    """B rounds of doubly-stochastic gossip x <- H x over an arbitrary
    :class:`~repro_torch.core.topology.Topology` (paper §III).

    The topology's static exchange schedule, ``(permutation, weight)``
    steps, runs as gathers over the worker dimension; ``TimeVarying``
    topologies cycle one sub-schedule per round.

    ``compress=True`` (default) collapses the B serial rounds into ONE
    mix with the precomputed power matrix H^B, compiled through the
    Birkhoff-von-Neumann path (:meth:`Topology.power_schedule`), when
    that schedule is shallower than the serial one: about |support(H^B)|
    weighted hops instead of B x edges.  The result equals ``H**B @ x``
    up to float reassociation; ``compress=False`` runs the hop-by-hop
    serial schedule (bit-identical to ``consensus.ring_gossip_average``
    for a ring).

    ``wire_dtype`` (``"float32"`` default, ``"bfloat16"``/``"float16"``)
    narrows every link payload: messages are cast once before the wire
    and accumulated in full precision on receipt.  Eq.-15 exchange
    *counts* stay the mathematical B x edges regardless of compression.
    """

    rounds: int = 1
    topology: Topology = Ring(1)
    compress: bool = True
    wire_dtype: str = "float32"

    mode_name = "gossip"

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1, got {self.rounds}")
        if not isinstance(self.topology, Topology):
            raise TypeError(
                f"topology must be a Topology, got {type(self.topology).__name__}"
            )
        object.__setattr__(
            self, "wire_dtype",
            consensus_lib.canonical_wire_dtype(self.wire_dtype),
        )

    @property
    def degree(self) -> int:
        """Legacy ``backend.degree`` view (ring topologies only)."""
        return getattr(self.topology, "degree", 1)

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return consensus_lib.WIRE_DTYPES[self.wire_dtype]

    def validate(self, num_workers: int) -> None:
        self.topology.validate(num_workers)

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        return _cycle_exchanges(self.topology, self.rounds, num_workers)

    @property
    def _compressible(self) -> bool:
        # rounds=1 over a single graph IS its native schedule already.
        return self.compress and not (
            self.rounds == 1 and len(self.topology.cycle()) == 1
        )

    def _serial_hops(self, num_workers: int) -> int:
        # Each distinct cycle entry's schedule is built once, then the
        # hops are counted over the round sequence.
        per_phase = [
            len(topology_lib.cached_exchange_schedule(t, num_workers).perms)
            for t in self.topology.cycle()
        ]
        return sum(
            per_phase[b % len(per_phase)] for b in range(self.rounds)
        )

    def _compressed_schedule_or_none(self, num_workers: int):
        """The H^B schedule IF it is shallower than B serial rounds.
        Vertex-transitive graphs compress to <= M-1 hops, but the
        Birkhoff depth of an irregular (geometric) power can exceed the
        serial hop count: compression applies only where it wins."""
        if not self._compressible:
            return None
        sched = topology_lib.compressed_schedule(
            self.topology, num_workers, self.rounds
        )
        if len(sched.perms) >= self._serial_hops(num_workers):
            return None
        return sched

    def hops_for(self, num_workers: int) -> int:
        """Permutation hops one ``mix`` executes: the compressed
        schedule's depth, or every edge of every round when serial."""
        sched = self._compressed_schedule_or_none(num_workers)
        if sched is not None:
            return len(sched.perms)
        return self._serial_hops(num_workers)

    def mix(self, x, state, ctx):
        wd = None if self.wire_dtype == "float32" else self.wire_dtype
        sched = self._compressed_schedule_or_none(ctx.num_workers)
        if sched is not None:
            # One mix with H^B: the whole B-round schedule as one
            # minimal-depth weighted hop sequence.
            return consensus_lib.schedule_gossip_step(
                x, sched, wire_dtype=wd, ctx=ctx
            ), state
        scheds = _cycle_schedules(self.topology, ctx)
        if len(scheds) == 1:
            # The bit-identity path for Ring (ring_gossip_average's hops).
            out = consensus_lib.schedule_gossip_average(
                x, scheds[0], self.rounds, wire_dtype=wd, ctx=ctx
            )
        else:
            out = x
            for b in range(self.rounds):
                out = consensus_lib.schedule_gossip_step(
                    out, scheds[b % len(scheds)], wire_dtype=wd, ctx=ctx
                )
        return out, state


def RingGossip(
    rounds: int = 1,
    degree: int = 1,
    *,
    compress: bool = True,
    wire_dtype: str = "float32",
) -> Gossip:
    """The paper's degree-d circular gossip: an alias for
    ``Gossip(rounds, topology=Ring(degree))``.  With ``compress=False``
    (and a full-width wire) it executes ``ring_gossip_average``'s hop
    sequence bit for bit; the default compressed form mixes once with
    H^B instead (equal up to float reassociation)."""
    return Gossip(
        rounds=rounds, topology=Ring(degree=degree),
        compress=compress, wire_dtype=wire_dtype,
    )


# ------------------------------------------------------------ key chain

def _worker_key(seed: int, ctx: ConsensusContext) -> np.ndarray:
    """Per-worker threefry keys from a static seed, stacked (M, 2): the
    reference's ``fold_in(PRNGKey(seed), axis_index)`` for every worker."""
    return prng.fold_in(prng.PRNGKey(seed), np.arange(ctx.num_workers))


def _frozen(array: np.ndarray) -> np.ndarray:
    array.setflags(write=False)
    return array


@functools.lru_cache(maxsize=512)
def _key_chain(key_bytes: bytes, num_workers: int, steps: int, device: torch.device):
    """``steps`` rounds of ``key, sub = split(key)`` from the (M, 2) keys
    in ``key_bytes``: the advanced keys (host) and the subkeys, (steps,
    M, 2), as int64 words on ``device``."""
    key = np.frombuffer(key_bytes, np.uint32).reshape(num_workers, 2)
    subs = []
    for _ in range(steps):
        pair = prng.split(key)
        key, sub = pair[:, 0], pair[:, 1]
        subs.append(sub)
    return _frozen(np.ascontiguousarray(key)), to_device(np.stack(subs).astype(np.int64), device)


def _device_views(parts: list, device: torch.device) -> list:
    """Host arrays of one dtype moved to ``device`` in one copy, each as
    a view of its own shape."""
    flat = to_device(np.concatenate([np.ravel(p) for p in parts]), device)
    views, offset = [], 0
    for p in parts:
        views.append(flat[offset:offset + p.size].view(p.shape))
        offset += p.size
    return views


@functools.lru_cache(maxsize=512)
def _lossy_draws(policy: "LossyGossip", key_bytes: bytes, num_workers: int,
                 device: torch.device):
    """One ``LossyGossip.mix``'s link draws from the (M, 2) keys in
    ``key_bytes``: for each round, ``key, sub = split(key)`` and
    :func:`consensus.lossy_link_weights` of ``sub``, moved to ``device``
    in one copy.  Returns the advanced keys and each round's
    ``(coef, wsum)`` tensors."""
    key = np.frombuffer(key_bytes, np.uint32).reshape(num_workers, 2)
    cycle = policy.topology.cycle()
    scheds = [topology_lib.cached_exchange_schedule(t, num_workers) for t in cycle]
    parts = []
    for b in range(policy.rounds):
        pair = prng.split(key)
        key, sub = pair[:, 0], pair[:, 1]
        parts += consensus_lib.lossy_link_weights(
            scheds[b % len(scheds)], policy.drop_prob, sub
        )
    views = _device_views(parts, device)
    return _frozen(np.ascontiguousarray(key)), tuple(zip(views[::2], views[1::2]))


# ----------------------------------------------------------- quantized

@dataclass(frozen=True)
class QuantizedGossip(ConsensusPolicy):
    """k-bit links: every exchanged message is quantized before it goes
    on the wire.  ``stochastic=True`` uses unbiased stochastic rounding
    (E[q(x)] = x), so the consensus preserves the doubly-stochastic mean
    in expectation; eq.-15 traffic scales by bits/32 (``wire_bits``).

    ``topology=None`` (default) keeps the original form: one quantized
    all-reduce per ``mix``, every worker's own term quantized too.  With
    a topology, each of ``rounds`` gossip rounds quantizes the outgoing
    message and mixes it over the graph's exchange schedule; the
    receiver's own contribution stays full-precision (only the wire is
    narrow)."""

    bits: int = 8
    stochastic: bool = True
    seed: int = 0
    rounds: int = 1
    topology: Topology | None = None

    mode_name = "quantized"

    def __post_init__(self):
        if not 1 <= self.bits <= 32:
            raise ValueError(f"quantization bits must be in [1, 32], got {self.bits}")
        if self.rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1, got {self.rounds}")

    def validate(self, num_workers: int) -> None:
        if self.topology is not None:
            self.topology.validate(num_workers)

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return self.bits

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        if self.topology is None:
            return 1
        return _cycle_exchanges(self.topology, self.rounds, num_workers)

    def init_state(self, x, ctx):
        return _worker_key(self.seed, ctx)

    def _quantize(self, x, key):
        if self.stochastic:
            return consensus_lib.quantize_stochastic(x, self.bits, key)
        return consensus_lib.quantize_nearest(x, self.bits)

    def mix(self, x, state, ctx):
        steps = 1 if self.topology is None else self.rounds
        key, subs = _key_chain(state.tobytes(), ctx.num_workers, steps, x.device)
        if self.topology is None:
            return ctx.pmean(self._quantize(x, ctx.local_rows(subs[0]))), key
        scheds = _cycle_schedules(self.topology, ctx)
        for b in range(self.rounds):
            q = self._quantize(x, ctx.local_rows(subs[b]))
            x = consensus_lib.schedule_gossip_step(
                q, scheds[b % len(scheds)], self_value=x, ctx=ctx
            )
        return x, key


# --------------------------------------------------------------- lossy

@dataclass(frozen=True, init=False)
class LossyGossip(ConsensusPolicy):
    """Gossip over a lossy network: each incoming link fails
    independently with probability ``drop_prob`` per round, and the
    receiver renormalizes its mixing row over surviving links (the
    self-link never drops): row-stochastic per round but not doubly
    stochastic, which is why naive lossy gossip biases the mean (paper
    §IV / ref [16] relaxed ADMM).

    ``topology=`` is the authoritative graph; ``degree=d`` is a pure
    construction shorthand for ``topology=Ring(d)`` and NOT a stored
    field: ``LossyGossip(degree=2)`` and ``LossyGossip(topology=Ring(2))``
    are the same value object.  Passing both is an error.  Per-round link
    failures never compress (each round draws its own survivors), but
    ``wire_dtype`` narrows the surviving payloads as in :class:`Gossip`.
    The rounds' link draws are made on the host (:func:`_lossy_draws`);
    the device adds the surviving messages."""

    drop_prob: float = 0.1
    rounds: int = 1
    seed: int = 0
    topology: Topology | None = None
    wire_dtype: str = "float32"

    mode_name = "lossy"

    def __init__(
        self,
        drop_prob: float = 0.1,
        rounds: int = 1,
        degree: int | None = None,
        seed: int = 0,
        topology: Topology | None = None,
        wire_dtype: str = "float32",
    ):
        if not 0.0 <= drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), got {drop_prob}")
        if rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1, got {rounds}")
        if degree is not None:
            if topology is not None:
                raise ValueError(
                    "pass either degree (the Ring shorthand) or topology=, "
                    "not both"
                )
            topology = Ring(degree)
        elif topology is None:
            topology = Ring(1)
        if not isinstance(topology, Topology):
            raise TypeError(
                f"topology must be a Topology, got {type(topology).__name__}"
            )
        object.__setattr__(self, "drop_prob", drop_prob)
        object.__setattr__(self, "rounds", rounds)
        object.__setattr__(self, "seed", seed)
        object.__setattr__(self, "topology", topology)
        object.__setattr__(
            self, "wire_dtype", consensus_lib.canonical_wire_dtype(wire_dtype)
        )

    @property
    def degree(self) -> int:
        """Legacy ring-degree view (mirrors ``Gossip.degree``); the
        stored ``topology`` is authoritative."""
        return getattr(self.topology, "degree", 1)

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return consensus_lib.WIRE_DTYPES[self.wire_dtype]

    def validate(self, num_workers: int) -> None:
        self.topology.validate(num_workers)

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        return _cycle_exchanges(self.topology, self.rounds, num_workers)

    def init_state(self, x, ctx):
        return _worker_key(self.seed, ctx)

    def mix(self, x, state, ctx):
        # The reference scans a single schedule and loops over a cycle;
        # both draw the same keys, so one loop serves.
        wd = None if self.wire_dtype == "float32" else self.wire_dtype
        scheds = _cycle_schedules(self.topology, ctx)
        key, rounds = _lossy_draws(self, state.tobytes(), ctx.num_workers, x.device)
        for b, (coef, wsum) in enumerate(rounds):
            x = consensus_lib.lossy_gossip_apply(
                x, scheds[b % len(scheds)], coef, wsum, wire_dtype=wd, ctx=ctx
            )
        return x, key


# --------------------------------------------------------------- stale

@dataclass(frozen=True)
class StaleMixing(ConsensusPolicy):
    """Bounded-staleness asynchrony model (ARock-style, paper ref [15]):
    peers never see this worker's current value, they see the average of
    its last ``delay`` *transmitted* iterates.  The transmit buffer,
    ``(delay, M, ...)``, is the mix state; each worker substitutes its
    own fresh value for its own stale contribution.

    ``delay=0`` is exactly ``ExactMean``; as the ADMM iterates converge
    the stale window mean converges to the true mean, so the fixed point
    is unchanged (large ``delay`` with a large ADMM ``mu`` can oscillate:
    delays up to ~3 are stable at the default hyper-parameters).

    ``topology=None`` (default) mixes the stale messages with one exact
    all-reduce; a topology mixes them over its exchange schedule, each
    worker still substituting its own FRESH value (``self_value``).
    Time-varying topologies are rejected: one ``mix`` is one schedule
    application, with no round index to cycle on.
    """

    delay: int = 1
    topology: Topology | None = None
    wire_dtype: str = "float32"

    mode_name = "stale"

    def __post_init__(self):
        if self.delay < 0:
            raise ValueError(f"staleness delay must be >= 0, got {self.delay}")
        object.__setattr__(
            self, "wire_dtype",
            consensus_lib.canonical_wire_dtype(self.wire_dtype),
        )

    def validate(self, num_workers: int) -> None:
        if self.topology is not None:
            if len(self.topology.cycle()) > 1:
                raise ValueError(
                    "StaleMixing applies one schedule per mix; time-varying "
                    "topologies have no round to cycle on"
                )
            self.topology.validate(num_workers)

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        if self.topology is None:
            return 1
        return self.topology.edges_per_node(num_workers)

    @property
    def is_exact(self) -> bool:
        return (
            self.delay == 0
            and self.topology is None
            and self.wire_dtype == "float32"
        )

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return consensus_lib.WIRE_DTYPES[self.wire_dtype]

    def _mix_messages(self, msg: Tensor, fresh: Tensor, ctx: ConsensusContext):
        """Average the peers' (stale) messages, substituting each
        worker's fresh value for its own stale term."""
        wd = None if self.wire_dtype == "float32" else self.wire_dtype
        if self.topology is None:
            if wd is not None:
                # The narrow wire of the all-reduce form: every message is
                # cast once; each worker swaps its own (narrowed) term for
                # the full-precision fresh value.
                narrow = consensus_lib._TORCH_WIRE_DTYPES[wd]
                msg = msg.to(narrow).to(fresh.dtype)
            if fresh is msg:  # delay=0: the message IS the fresh value
                return ctx.pmean(msg)
            return ctx.pmean(msg) + exact_div(fresh - msg, ctx.num_workers)
        sched = self.topology.exchange_schedule(ctx.num_workers)
        return consensus_lib.schedule_gossip_step(
            msg, sched, self_value=fresh, wire_dtype=wd, ctx=ctx
        )

    def init_state(self, x, ctx):
        if self.delay == 0:
            return ()
        # The transmit buffer, oldest first: what peers can see over the
        # next `delay` rounds.  Zeros match the ADMM zero-initialization
        # (O^0 = Lam^0 = 0), i.e. "nothing sent yet".
        return torch.zeros((self.delay,) + tuple(x.shape), dtype=x.dtype, device=x.device)

    def mix(self, x, state, ctx):
        if self.delay == 0:
            return self._mix_messages(x, x, ctx), state
        # Strictly pre-push: the current x is NOT in the message.
        msg = exact_div(state.sum(dim=0), self.delay)
        new_buf = torch.cat([state[1:], x[None]], dim=0)
        return self._mix_messages(msg, x, ctx), new_buf

    def one_shot(self, x, ctx):
        # A fresh init_state means "nothing transmitted yet" (zeros), which
        # would make a lone mix return x/M.  For one-shot use, seed the
        # window at its steady state, whose mix is exactly the mean (or
        # the topology's one-round H-average of it).
        if self.delay == 0:
            return self._mix_messages(x, x, ctx)
        steady = x[None].expand((self.delay,) + tuple(x.shape))
        out, _ = self.mix(x, steady, ctx)
        return out


# --------------------------------------------------------------- async

#: Byzantine attack kinds the fault model can inject (the ``attack=``
#: grammar): ``signflip`` / ``nanbomb`` take no argument, ``scale:c`` /
#: ``noise:s`` take a float, ``replay:d`` an integer delay >= 1.
_ATTACK_KINDS = ("signflip", "scale", "noise", "nanbomb", "replay")


def _parse_attack(spec: str):
    """``"scale:10"`` -> ``("scale", 10.0)``; validates kind and arg."""
    kind, _, arg = spec.partition(":")
    if kind not in _ATTACK_KINDS:
        raise ValueError(
            f"unknown attack {kind!r}; expected one of {_ATTACK_KINDS} "
            f"(attack spec {spec!r})"
        )
    if kind in ("signflip", "nanbomb"):
        if arg:
            raise ValueError(f"{kind} attack takes no ':' argument ({spec!r})")
        return kind, None
    if not arg:
        raise ValueError(
            f"{kind} attack needs an argument, e.g. '{kind}:2' ({spec!r})"
        )
    if kind == "replay":
        depth = int(arg)
        if depth < 1:
            raise ValueError(f"replay depth must be >= 1, got {depth}")
        return kind, depth
    return kind, float(arg)


@functools.lru_cache(maxsize=4096)
def _alive_rows(faults: "FaultModel", iteration: int, rounds: tuple, num_workers: int):
    """The (len(rounds), M) f32 up-masks of the given gossip rounds at one
    ADMM iteration, on the host: each round's Bernoulli draw from
    ``fold_in(fold_in(PRNGKey(seed), iteration), round)``, times the
    permanent-failure gate."""
    alive = np.ones((len(rounds), num_workers), np.float32)
    if faults.drop > 0.0:
        key = prng.fold_in(prng.PRNGKey(faults.seed), iteration)
        keys = prng.fold_in(key, np.asarray(rounds, np.int64))
        alive = prng.bernoulli(keys, 1.0 - faults.drop, (num_workers,)).astype(np.float32)
    if faults.failed:
        fail = faults._member_mask(faults.failed, num_workers).astype(np.float32)
        down = fail * np.float32(iteration >= faults.fail_at)
        alive = alive * (np.float32(1.0) - down)
    return _frozen(alive)


@functools.lru_cache(maxsize=256)
def _noise(seed: int, iteration: int, round_idx: int, shape: tuple, device: torch.device):
    """The ``noise`` attack's draw: ``normal(fold_in(fold_in(fold_in(
    PRNGKey(seed), 0x4E5A), iteration), round), shape)`` in f32, made on
    the host and moved to ``device``."""
    key = prng.fold_in(prng.PRNGKey(seed), 0x4E5A)
    key = prng.fold_in(prng.fold_in(key, iteration), round_idx)
    return to_device(prng.normal(key, shape), device)


@functools.lru_cache(maxsize=64)
def _member_tensor(workers: tuple, num_workers: int, device: torch.device) -> Tensor:
    return torch.from_numpy(np.isin(np.arange(num_workers), workers)).to(device)


@dataclass(frozen=True)
class FaultModel:
    """Deterministic, seeded fault process, evaluated for all M workers
    at once.  Faults are data: the same policy serves every realized
    fault pattern.

    ``drop``: each worker independently misses each gossip round with
    this probability.  The draw folds ``(seed, iteration, round)`` into
    one key WITHOUT a worker index, so every worker sees the same (M,)
    mask, the shared knowledge the renormalization in
    ``consensus.faulty_schedule_gossip_step`` relies on.  No draw depends
    on the data, so the masks are drawn on the host (:mod:`repro_torch.
    prng`, the reference's words) and memoized: each layer's ADMM
    restarts the iteration count, and finds them drawn.

    ``failed``/``fail_at``: the listed workers go down permanently once
    the ADMM iteration reaches ``fail_at`` (crash-stop).

    ``stragglers``/``straggle``: the listed workers transmit the value
    they held ``straggle`` communicating rounds ago (zeros before the
    window fills); their OWN mixing input stays fresh.

    ``byzantine``/``attack``: the listed workers put a CORRUPTED payload
    on the wire every gossip round: ``signflip`` (-x), ``scale:c``
    (c*x), ``noise:s`` (x + s*N(0,1), seeded per (iteration, round), the
    same draw for every worker), ``nanbomb`` (all NaN), ``replay:d`` (the
    payload from d mixes ago, zeros before the window fills).  An
    attacker's own mixing input stays honest.
    """

    drop: float = 0.0
    seed: int = 0
    fail_at: int | None = None
    failed: tuple[int, ...] = ()
    straggle: int = 1
    stragglers: tuple[int, ...] = ()
    byzantine: tuple[int, ...] = ()
    attack: str = "signflip"

    def __post_init__(self):
        if not 0.0 <= self.drop < 1.0:
            raise ValueError(f"drop must be in [0, 1), got {self.drop}")
        object.__setattr__(
            self, "failed", tuple(sorted(int(i) for i in self.failed))
        )
        object.__setattr__(
            self, "stragglers", tuple(sorted(int(i) for i in self.stragglers))
        )
        object.__setattr__(
            self, "byzantine", tuple(sorted(int(i) for i in self.byzantine))
        )
        if self.failed and self.fail_at is None:
            object.__setattr__(self, "fail_at", 0)
        if self.fail_at is not None and self.fail_at < 0:
            raise ValueError(f"fail_at must be >= 0, got {self.fail_at}")
        if self.straggle < 1:
            raise ValueError(
                f"straggle delay must be >= 1 round, got {self.straggle}"
            )
        _parse_attack(self.attack)  # validate the spec even when unarmed

    @property
    def is_null(self) -> bool:
        """No fault source configured: policies fall through to their
        fault-free (bit-identical) mixing path."""
        return (
            self.drop == 0.0
            and not self.failed
            and not self.stragglers
            and not self.byzantine
        )

    @property
    def attack_kind(self) -> str:
        return _parse_attack(self.attack)[0]

    @property
    def attack_param(self):
        return _parse_attack(self.attack)[1]

    @property
    def replay_depth(self) -> int:
        """Transmit-history window the replay attack needs (0 = none)."""
        if self.byzantine and self.attack_kind == "replay":
            return self.attack_param
        return 0

    def validate(self, num_workers: int) -> None:
        for i in self.failed + self.stragglers + self.byzantine:
            if not 0 <= i < num_workers:
                raise ValueError(
                    f"fault model names worker {i}, mesh has {num_workers}"
                )
        if len(set(self.failed)) >= num_workers:
            raise ValueError("fault model permanently fails every worker")
        if len(set(self.byzantine)) >= num_workers:
            raise ValueError("fault model makes every worker Byzantine")

    def corrupted_payload(self, x: Tensor, *, iteration: int, round_idx: int,
                          replay: Tensor | None = None) -> Tensor:
        """The wire payload Byzantine workers transmit in place of the
        stacked ``x`` (M, ...).  Pure data: callers select it per worker
        with ``torch.where`` (never a multiply: NaN * 0 is NaN).  The
        ``noise`` draw is one (Q, n)-shaped f32 normal shared by every
        worker, as the reference's per-worker draws from one key are."""
        kind, param = _parse_attack(self.attack)
        if kind == "signflip":
            return -x
        if kind == "scale":
            return param * x
        if kind == "nanbomb":
            return torch.full_like(x, torch.nan)
        if kind == "replay":
            if replay is None:
                raise ValueError(
                    "replay attack needs the transmit-history buffer "
                    "(policy must thread replay_depth state)"
                )
            return replay
        noise = _noise(self.seed, int(iteration), int(round_idx), tuple(x.shape[1:]), x.device)
        return x + param * noise.to(x.dtype)

    def transmit_for(self, x: Tensor, *, iteration: int, round_idx: int,
                     replay: Tensor | None = None,
                     ctx: ConsensusContext | None = None) -> Tensor:
        """What each worker of the stacked ``x`` puts on the wire: the
        corrupted payload on Byzantine slots, its own value elsewhere
        (selected with ``torch.where``, so non-finite attack values never
        leak into honest transmissions).  ``ctx`` says which workers ``x``
        holds (default: all of them)."""
        if not self.byzantine:
            return x
        if ctx is None:
            byz = _member_tensor(self.byzantine, x.shape[0], x.device)
        else:
            byz = ctx.local_rows(_member_tensor(self.byzantine, ctx.num_workers, x.device))
        bad = self.corrupted_payload(
            x, iteration=iteration, round_idx=round_idx, replay=replay
        )
        return torch.where(byz.view((-1,) + (1,) * (x.ndim - 1)), bad, x)

    def _member_mask(self, workers: tuple[int, ...], num_workers: int):
        return np.isin(np.arange(num_workers), workers)

    def alive_mask(self, iteration: int, round_idx: int, num_workers: int,
                   dtype=torch.float32, device=None) -> Tensor:
        """(M,) 0/1 up-mask for one gossip round: the reference's Bernoulli
        words, drawn on the host, as a ``dtype`` tensor on ``device``."""
        rows = _alive_rows(self, int(iteration), (int(round_idx),), num_workers)
        return torch.from_numpy(rows[0].copy()).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=4096)
def _async_link_weights(policy: "AsyncGossip", t: int, num_workers: int,
                        dtype: torch.dtype, device: torch.device):
    """The link gates (:func:`consensus.faulty_link_weights`) of every
    round of ``policy``'s mix number ``t``, from the host's up-masks,
    moved to ``device`` in one copy: a tuple of ``(coef, lost)``."""
    faults = policy.faults
    scheds = [topology_lib.cached_exchange_schedule(p, num_workers)
              for p in policy.topology.cycle()]
    phase = t % len(scheds)
    iteration = t * policy.interval + (policy.interval - 1)
    alive = torch.from_numpy(np.array(
        _alive_rows(faults, iteration, tuple(range(policy.rounds)), num_workers)
    )).to(dtype)
    parts = []
    for b in range(policy.rounds):
        parts += [v.numpy() for v in consensus_lib.faulty_link_weights(
            scheds[(phase + b) % len(scheds)], alive[b]
        )]
    views = _device_views(parts, device)
    return tuple(zip(views[::2], views[1::2]))


@functools.lru_cache(maxsize=4096)
def _robust_alive(faults: FaultModel, t: int, rounds: int, num_workers: int,
                  dtype: torch.dtype, device: torch.device):
    """Each round's (M,) up-mask of a robust mix at iteration ``t``, on
    ``device`` in one copy, or None where every worker is up every round
    (the screen's link gate then passes every link)."""
    alive = _alive_rows(faults, t, tuple(range(rounds)), num_workers)
    if alive.all():
        return None
    return torch.from_numpy(np.array(alive)).to(device=device, dtype=dtype)


def _push(buf: Tensor, x: Tensor) -> Tensor:
    """A transmit-history buffer (oldest first) advanced by ``x``."""
    return torch.cat([buf[1:], x[None]], dim=0)


@dataclass(frozen=True)
class AsyncGossip(ConsensusPolicy):
    """Elastic asynchronous gossip: serial rounds over any topology, a
    communication interval (mix every ``interval``-th ADMM iteration,
    Bagua-style) and a seeded :class:`FaultModel`.

    With ``interval=N`` the ADMM loop runs N-1 purely local iterations
    per communicating one (``admm.worker_admm_iterations``), so the
    eq.-15 accounting (:meth:`comm_scalars`) scales by 1/N.  A
    ``TimeVarying`` topology rotates across communicating calls: call t
    starts on phase ``t % L`` (a host branch; the reference switches on
    the traced t).

    Faults renormalize on the fly (``faulty_schedule_gossip_step``): every
    realized mixing slice stays row-stochastic, and because only
    inverse-closed schedules are admitted under faults (``validate``), it
    keeps the mean over the up workers.  A null fault model falls through
    to the plain serial schedule path, bit-identical to
    ``Gossip(compress=False)`` over the same graph.

    The mix state is ``(t, [straggler buffer], [replay buffer])``: the
    call count t as a host integer (it seeds the fault draws, so keeping
    it on the host lets them be drawn there), then the (depth, M, ...)
    transmit histories.
    """

    rounds: int = 1
    interval: int = 1
    topology: Topology = Ring(1)
    faults: FaultModel = FaultModel()
    wire_dtype: str = "float32"

    mode_name = "async"

    def __post_init__(self):
        if self.rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1, got {self.rounds}")
        if self.interval < 1:
            raise ValueError(
                f"communication interval must be >= 1, got {self.interval}"
            )
        if not isinstance(self.topology, Topology):
            raise TypeError(
                f"topology must be a Topology, got {type(self.topology).__name__}"
            )
        if not isinstance(self.faults, FaultModel):
            raise TypeError(
                f"faults must be a FaultModel, got {type(self.faults).__name__}"
            )
        object.__setattr__(
            self, "wire_dtype",
            consensus_lib.canonical_wire_dtype(self.wire_dtype),
        )

    @property
    def degree(self) -> int:
        """Legacy ``backend.degree`` view (ring topologies only)."""
        return getattr(self.topology, "degree", 1)

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return consensus_lib.WIRE_DTYPES[self.wire_dtype]

    @property
    def communication_interval(self) -> int:
        return self.interval

    def validate(self, num_workers: int) -> None:
        self.topology.validate(num_workers)
        self.faults.validate(num_workers)
        if not self.faults.is_null:
            for phase in self.topology.cycle():
                sched = topology_lib.cached_exchange_schedule(
                    phase, num_workers
                )
                if not topology_lib.is_inverse_closed(sched):
                    raise ValueError(
                        "fault renormalization is mean-preserving only on "
                        "inverse-closed exchange schedules; "
                        f"{phase.describe()} compiles to an asymmetric hop "
                        "set (use a vertex-transitive or Masked topology)"
                    )

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        """Exchanges per COMMUNICATING mix (skipped rounds are accounted
        in :meth:`comm_scalars`, which divides the consensus count)."""
        return _cycle_exchanges(self.topology, self.rounds, num_workers)

    def comm_scalars(
        self, *, scalars: int, num_consensus: int,
        num_workers: int | None = None,
    ) -> int:
        # Only every interval-th consensus call touches the wire.
        return (
            scalars * self.exchanges_for(num_workers)
            * (num_consensus // self.interval)
        )

    def init_state(self, x, ctx):
        parts = [0]
        for depth in (
            self.faults.straggle if self.faults.stragglers else 0,
            self.faults.replay_depth,
        ):
            if depth:
                parts.append(torch.zeros(
                    (depth,) + tuple(x.shape), dtype=x.dtype, device=x.device
                ))
        return tuple(parts)

    def mix(self, x, state, ctx):
        t = state[0]
        wd = None if self.wire_dtype == "float32" else self.wire_dtype
        scheds = _cycle_schedules(self.topology, ctx)
        faults = self.faults
        # The ADMM iteration this mix call lands on (communicating
        # iterations close each interval chunk): what fail_at compares
        # against and what seeds the per-round drop draws.
        iteration = t * self.interval + (self.interval - 1)
        transmit = None
        strag_idx = 1 if faults.stragglers else None
        replay_idx = (2 if faults.stragglers else 1) if faults.replay_depth else None
        if faults.stragglers:
            strag = ctx.local_rows(
                _member_tensor(faults.stragglers, ctx.num_workers, x.device)
            )
            # Stragglers replay the value transmitted `straggle` calls
            # ago; everyone else sends fresh.
            transmit = x + strag.to(x.dtype).view(consensus_lib._worker_shape(x)) * (
                state[strag_idx][0] - x
            )
        replay_val = state[replay_idx][0] if replay_idx is not None else None

        if faults.is_null and transmit is None and len(scheds) == 1:
            # Healthy + fresh + single graph: the serial Gossip path, so a
            # disabled fault model is bit-identical to Gossip(compress=False).
            out = consensus_lib.schedule_gossip_average(
                x, scheds[0], self.rounds, wire_dtype=wd, ctx=ctx
            )
        else:
            phase = t % len(scheds)
            gates = None if faults.is_null else _async_link_weights(
                self, t, ctx.num_workers, x.dtype, x.device
            )
            out = x
            for b in range(self.rounds):
                sched = scheds[(phase + b) % len(scheds)]
                tx = transmit if b == 0 else None
                if faults.byzantine:
                    # Attackers corrupt EVERY round's outgoing payload; the
                    # honest base is the straggler transmit on round 0, the
                    # current mixed value after that.  AsyncGossip trusts
                    # what it receives: it is the vulnerable baseline.
                    tx = faults.transmit_for(
                        out if tx is None else tx,
                        iteration=iteration, round_idx=b, replay=replay_val,
                        ctx=ctx,
                    )
                if gates is None:
                    # A null fault model sends fresh values: tx is None.
                    out = consensus_lib.schedule_gossip_step(
                        out, sched, wire_dtype=wd, ctx=ctx
                    )
                else:
                    coef, lost = gates[b]
                    out = consensus_lib.faulty_gossip_apply(
                        out, sched, coef, lost, transmit=tx, wire_dtype=wd,
                        ctx=ctx,
                    )
        new_state = [t + 1]
        for idx in (strag_idx, replay_idx):
            if idx is not None:
                new_state.append(_push(state[idx], x))
        return out, tuple(new_state)


# ------------------------------------------------- robust aggregation

class _RobustGossipMixin:
    """Shared plumbing for the Byzantine-robust gossip family.

    * **Null fault model -> plain gossip, bit for bit.**  With no
      attackers (and no omission faults) the robust estimator would still
      distort the mean, so the policies run the serial Gossip path
      instead: the zero-attacker case is bit-identical to
      ``Gossip(compress=False)`` over the same graph.
    * **Any non-null fault model -> robust aggregation every round.**
      Byzantine members corrupt their outgoing payload
      (``FaultModel.transmit_for``), every incoming payload is screened
      for non-finite values and rerouted to the receiver's diagonal when
      unhealthy, and the surviving neighborhood goes through the robust
      estimator (trim / median / clip).
    * An attacker's own mixing input stays honest.

    The fault draws take ``iteration = t``, the call count, where
    ``AsyncGossip`` takes the ADMM iteration of its interval; the
    reference does the same.  The mix state is ``(t, [replay buffer])``,
    t a host integer.
    """

    # Concrete classes: dataclass fields (estimator knob first), a
    # ``mode_name``, and ``_aggregate``; everything else lives here.

    def _robust_post_init(self):
        if self.rounds < 1:
            raise ValueError(f"gossip rounds must be >= 1, got {self.rounds}")
        if not isinstance(self.topology, Topology):
            raise TypeError(
                f"topology must be a Topology, got {type(self.topology).__name__}"
            )
        if not isinstance(self.faults, FaultModel):
            raise TypeError(
                f"faults must be a FaultModel, got {type(self.faults).__name__}"
            )
        object.__setattr__(
            self, "wire_dtype",
            consensus_lib.canonical_wire_dtype(self.wire_dtype),
        )

    @property
    def degree(self) -> int:
        """Legacy ``backend.degree`` view (ring topologies only)."""
        return getattr(self.topology, "degree", 1)

    @property
    def wire_bits(self) -> int:  # type: ignore[override]
        return consensus_lib.WIRE_DTYPES[self.wire_dtype]

    @property
    def exchanges_per_round(self) -> int:
        return self.exchanges_for(None)

    def exchanges_for(self, num_workers: int | None) -> int:
        return _cycle_exchanges(self.topology, self.rounds, num_workers)

    def validate(self, num_workers: int) -> None:
        self.topology.validate(num_workers)
        self.faults.validate(num_workers)
        if self.faults.stragglers:
            raise ValueError(
                f"{type(self).__name__} transmits fresh payloads only; "
                "model stragglers with AsyncGossip"
            )
        for phase in self.topology.cycle():
            sched = topology_lib.cached_exchange_schedule(phase, num_workers)
            self._validate_schedule(phase, sched)

    def _validate_schedule(self, phase, sched) -> None:
        """Per-phase schedule admission (estimator-specific)."""

    def init_state(self, x, ctx):
        if self.faults.replay_depth:
            buf = torch.zeros(
                (self.faults.replay_depth,) + tuple(x.shape),
                dtype=x.dtype, device=x.device,
            )
            return (0, buf)
        return (0,)

    def mix(self, x, state, ctx):
        t = state[0]
        wd = None if self.wire_dtype == "float32" else self.wire_dtype
        scheds = _cycle_schedules(self.topology, ctx)
        faults = self.faults
        replay_val = state[1][0] if faults.replay_depth else None
        if faults.is_null and len(scheds) == 1:
            # Healthy network: the serial Gossip path (robust estimation
            # engages only under a non-null fault model).
            out = consensus_lib.schedule_gossip_average(
                x, scheds[0], self.rounds, wire_dtype=wd, ctx=ctx
            )
        else:
            phase = t % len(scheds)
            alive = None if faults.is_null else _robust_alive(
                faults, t, self.rounds, ctx.num_workers, x.dtype, x.device
            )
            out = x
            for b in range(self.rounds):
                sched = scheds[(phase + b) % len(scheds)]
                if faults.is_null:
                    out = consensus_lib.schedule_gossip_step(
                        out, sched, wire_dtype=wd, ctx=ctx
                    )
                    continue
                tx = faults.transmit_for(
                    out, iteration=t, round_idx=b, replay=replay_val, ctx=ctx
                ) if faults.byzantine else None
                out = self._aggregate(
                    out, sched, None if alive is None else alive[b], tx, wd, ctx
                )
        if faults.replay_depth:
            return out, (t + 1, _push(state[1], x))
        return out, (t + 1,)


@dataclass(frozen=True)
class TrimmedMeanGossip(_RobustGossipMixin, ConsensusPolicy):
    """Screened trimmed-mean gossip: each round every receiver trims
    (reroutes to its own diagonal) up to ``f`` neighborhood payloads,
    picked as the most-deviant links (Frobenius distance from the
    receiver) that stand beyond the neighborhood scale
    (``consensus.TRIM_SCREEN_FACTOR`` x the median link distance).  The
    surviving links mix with their exact gossip weights, so honest
    traffic is never distorted; a Byzantine payload outside the honest
    spread loses its whole link weight.  Tolerates up to ``f`` attackers
    per neighborhood within the breakdown bound ``2f < |neighborhood|``.
    Requires uniform exchange schedules (equal hop weights).
    """

    f: int = 1
    rounds: int = 1
    topology: Topology = Ring(1)
    faults: FaultModel = FaultModel()
    wire_dtype: str = "float32"

    mode_name = "trimmed"

    def __post_init__(self):
        if self.f < 1:
            raise ValueError(
                f"trimmed mean needs f >= 1 (use Gossip for f=0), got {self.f}"
            )
        self._robust_post_init()

    def _validate_schedule(self, phase, sched) -> None:
        if not sched.uniform:
            raise ValueError(
                "trimmed-mean gossip needs a uniform exchange schedule; "
                f"{phase.describe()} compiles to weighted hops"
            )
        stack = len(sched.perms) + 1
        if 2 * self.f >= stack:
            raise ValueError(
                f"trimmed mean with f={self.f} needs a neighborhood of "
                f"> {2 * self.f} payloads; {phase.describe()} gives {stack}"
            )

    def _aggregate(self, out, sched, alive, tx, wd, ctx):
        return consensus_lib.trimmed_mean_schedule_gossip_step(
            out, sched, trim=self.f, alive=alive, transmit=tx, wire_dtype=wd,
            ctx=ctx,
        )


@dataclass(frozen=True)
class MedianGossip(_RobustGossipMixin, ConsensusPolicy):
    """Coordinate-wise median gossip: the maximal-breakdown member of the
    trimmed-mean family (survives just under half the neighborhood being
    Byzantine, at the price of the largest honest-case bias).  Uniform
    schedules only, like :class:`TrimmedMeanGossip`.
    """

    rounds: int = 1
    topology: Topology = Ring(1)
    faults: FaultModel = FaultModel()
    wire_dtype: str = "float32"

    mode_name = "median"

    def __post_init__(self):
        self._robust_post_init()

    def _validate_schedule(self, phase, sched) -> None:
        if not sched.uniform:
            raise ValueError(
                "median gossip needs a uniform exchange schedule; "
                f"{phase.describe()} compiles to weighted hops"
            )

    def _aggregate(self, out, sched, alive, tx, wd, ctx):
        return consensus_lib.median_schedule_gossip_step(
            out, sched, alive=alive, transmit=tx, wire_dtype=wd, ctx=ctx,
        )


@dataclass(frozen=True)
class ClippedGossip(_RobustGossipMixin, ConsensusPolicy):
    """Norm-clipped gossip (centered clipping): each incoming payload's
    offset from self is clipped to radius ``tau`` before the weighted
    mix, bounding any single attacker's per-round influence by ``w *
    tau`` while leaving nearby honest payloads untouched.  Works on ANY
    schedule (weighted hops included): clipping is per link.
    """

    tau: float = 1.0
    rounds: int = 1
    topology: Topology = Ring(1)
    faults: FaultModel = FaultModel()
    wire_dtype: str = "float32"

    mode_name = "clipped"

    def __post_init__(self):
        if not self.tau > 0.0:
            raise ValueError(f"clip radius tau must be > 0, got {self.tau}")
        self._robust_post_init()

    def _aggregate(self, out, sched, alive, tx, wd, ctx):
        return consensus_lib.clipped_schedule_gossip_step(
            out, sched, tau=self.tau, alive=alive, transmit=tx, wire_dtype=wd,
            ctx=ctx,
        )


# ------------------------------------------------------------- parsing

#: Spec-grammar policy names (``parse_policy`` / ``dssfn.parse_spec``).
_MODES = (
    "exact", "gossip", "quantized", "lossy", "stale", "async",
    "trimmed", "median", "clipped",
)

#: Max positional ``:``-separated arguments each policy spec accepts;
#: extra segments are an error, never silently dropped.  ``key=value``
#: segments are counted separately (see ``parse_policy``).
_SPEC_MAX_ARGS = {
    "exact": 0, "gossip": 2, "quantized": 1, "lossy": 3, "stale": 1,
    "async": 0, "trimmed": 0, "median": 0, "clipped": 1,
}

#: One-line-per-entry grammar, quoted in full by unknown-token errors.
_POLICY_GRAMMAR = """\
  exact                                   one all-reduce (true mean)
  gossip[:B[:d]]                          B gossip rounds, ring degree d
  quantized[:bits]                        stochastic k-bit quantized gossip
  lossy[:p[:B[:d]]]                       per-link drop probability p
  stale[:delay]                           delayed self-substitution mixing
  async[:key=value...]                    interval= rounds= seed= drop=
                                          fail= fail_at= stragglers=
                                          straggle= byz= attack=
  trimmed[:key=value...]                  f= rounds= + fault keys
  median[:key=value...]                   rounds= + fault keys
  clipped[:tau][:key=value...]            tau= rounds= + fault keys
Any gossip-family policy also takes wire=f32|bf16|f16, and attacks are
signflip | scale:c | noise:s | nanbomb | replay:d (byz= picks workers,
attack= alone defaults to byz=0).  Append @topology to pick the graph:
  ring[:d] | torus:RxC | hypercube | geometric:r[:seed] | full
  ('+'-join phases for a time-varying cycle, e.g. ring:1+hypercube)"""

def _int_list(text: str) -> tuple[int, ...]:
    """``"1+3+6"`` -> ``(1, 3, 6)`` (the spec grammar's worker lists)."""
    return tuple(int(s) for s in text.split("+") if s)


def _faults_from_kv(kv: dict) -> FaultModel:
    """Consume the fault-grammar keys shared by ``async`` and the robust
    policies (``drop``/``seed``/``fail``/``fail_at``/``stragglers``/
    ``straggle``/``byz``/``attack``) out of ``kv``.  ``attack=`` without
    ``byz=`` arms worker 0, the one-attacker smoke spec."""
    fail_at = kv.pop("fail_at", None)
    attack = kv.pop("attack", None)
    byzantine = _int_list(kv.pop("byz", ""))
    if attack is not None and not byzantine:
        byzantine = (0,)
    return FaultModel(
        drop=float(kv.pop("drop", 0.0)),
        seed=int(kv.pop("seed", 0)),
        fail_at=None if fail_at is None else int(fail_at),
        failed=_int_list(kv.pop("fail", "")),
        straggle=int(kv.pop("straggle", 1)),
        stragglers=_int_list(kv.pop("stragglers", "")),
        byzantine=byzantine,
        attack=attack if attack is not None else "signflip",
    )


def parse_policy(
    spec: str,
    *,
    degree: int = 1,
    rounds: int = 1,
    topology: "Topology | str | None" = None,
) -> ConsensusPolicy:
    """CLI policy specs: ``exact | gossip[:B[:d]] | quantized:bits |
    lossy:p[:B[:d]] | stale:delay | async[:key=value...] |
    trimmed[:key=value...] | median[:key=value...] |
    clipped[:tau][:key=value...]``, the reference's grammar and errors.

    ``degree``/``rounds`` fill the segments the spec leaves out;
    ``key=value`` segments configure ``wire=`` and the async/fault
    grammar (``async:interval=4:drop=0.1:rounds=2:seed=7:fail=2+5:
    fail_at=30:stragglers=1:straggle=3``, worker lists ``+``-joined);
    the robust policies share the fault keys plus the Byzantine pair
    ``byz=0+3:attack=signflip`` (``attack=`` alone arms worker 0).  An
    ``@topology`` half (or ``topology=``, a ``Topology`` or a
    ``parse_topology`` spec) replaces the default ring.

    >>> parse_policy("gossip:3").topology
    Ring(degree=1)
    >>> parse_policy("async:interval=4:drop=0.1").communication_interval
    4
    """
    if isinstance(topology, str):
        topology = parse_topology(topology)
    spec, at, graph = spec.partition("@")
    if at:
        if topology is not None:
            raise ValueError(
                f"policy spec {spec!r}@{graph!r} names an '@topology' AND "
                "one was passed explicitly; drop one of them"
            )
        topology = parse_topology(graph)
    segments = [s for s in spec.split(":") if s]
    name = segments[0] if segments else spec
    args: list[str] = []
    kv: dict[str, str] = {}
    last_key: str | None = None
    for seg in segments[1:]:
        if "=" in seg:
            k, _, v = seg.partition("=")
            if k in kv:
                raise ValueError(
                    f"bad consensus policy spec {spec!r}: duplicate key {k!r}"
                )
            kv[k] = v
            last_key = k
        elif last_key == "attack":
            # Attack specs carry their own ':'-argument (scale:10,
            # noise:0.5, replay:3): rejoin the segment the split took off.
            kv["attack"] += ":" + seg
            last_key = None
        else:
            args.append(seg)
            last_key = None
    if name not in _MODES:
        raise ValueError(
            f"unknown consensus policy {name!r} (spec {spec!r}); "
            f"the full grammar:\n{_POLICY_GRAMMAR}"
        )
    if len(args) > _SPEC_MAX_ARGS[name]:
        raise ValueError(
            f"bad consensus policy spec {spec!r}: {name} takes at most "
            f"{_SPEC_MAX_ARGS[name]} positional ':'-argument(s), got {len(args)}"
        )
    if topology is not None and name == "exact":
        raise ValueError(
            f"bad consensus policy spec {spec!r}: exact consensus is a "
            "single all-reduce and takes no topology (use a gossip-family "
            "policy)"
        )
    try:
        wire = kv.pop("wire", None)
        if wire is not None and name in ("exact", "quantized"):
            raise ValueError(f"{name} takes no wire= (it has no gossip link)")
        wire = consensus_lib.canonical_wire_dtype(wire or "float32")
        if name == "async":
            b = int(kv.pop("rounds", rounds))
            interval = int(kv.pop("interval", 1))
            faults = _faults_from_kv(kv)
            if kv:
                raise ValueError(f"unknown async key(s) {sorted(kv)}")
            return AsyncGossip(
                rounds=b, interval=interval,
                topology=topology if topology is not None else Ring(degree),
                faults=faults, wire_dtype=wire,
            )
        if name in ("trimmed", "median", "clipped"):
            b = int(kv.pop("rounds", rounds))
            graph = topology if topology is not None else Ring(degree)
            if name == "trimmed":
                f = int(kv.pop("f", 1))
                faults = _faults_from_kv(kv)
                if kv:
                    raise ValueError(f"unknown trimmed key(s) {sorted(kv)}")
                return TrimmedMeanGossip(
                    f=f, rounds=b, topology=graph, faults=faults,
                    wire_dtype=wire,
                )
            if name == "median":
                faults = _faults_from_kv(kv)
                if kv:
                    raise ValueError(f"unknown median key(s) {sorted(kv)}")
                return MedianGossip(
                    rounds=b, topology=graph, faults=faults, wire_dtype=wire,
                )
            tau_kv = kv.pop("tau", None)
            if tau_kv is not None and args:
                raise ValueError(
                    "pass the clip radius either positionally "
                    "(clipped:0.5) or as tau=, not both"
                )
            tau = float(
                tau_kv if tau_kv is not None else (args[0] if args else 1.0)
            )
            faults = _faults_from_kv(kv)
            if kv:
                raise ValueError(f"unknown clipped key(s) {sorted(kv)}")
            return ClippedGossip(
                tau=tau, rounds=b, topology=graph, faults=faults,
                wire_dtype=wire,
            )
        if kv:
            raise ValueError(f"unknown {name} key(s) {sorted(kv)}")
        if name == "exact":
            return ExactMean()
        if name == "gossip":
            b = int(args[0]) if args else rounds
            if topology is not None:
                if len(args) > 1:
                    raise ValueError(
                        "pass either a ring degree segment or topology=, "
                        "not both"
                    )
                return Gossip(rounds=b, topology=topology, wire_dtype=wire)
            deg = int(args[1]) if len(args) > 1 else degree
            return RingGossip(rounds=b, degree=deg, wire_dtype=wire)
        if name == "quantized":
            bits = int(args[0]) if args else 8
            if topology is not None:
                return QuantizedGossip(bits=bits, rounds=rounds, topology=topology)
            return QuantizedGossip(bits=bits)
        if name == "lossy":
            p = float(args[0]) if args else 0.1
            b = int(args[1]) if len(args) > 1 else rounds
            if topology is not None:
                if len(args) > 2:
                    raise ValueError(
                        "pass either a ring degree segment or topology=, "
                        "not both"
                    )
                return LossyGossip(
                    drop_prob=p, rounds=b, topology=topology, wire_dtype=wire
                )
            deg = int(args[2]) if len(args) > 2 else degree
            return LossyGossip(
                drop_prob=p, rounds=b, degree=deg, wire_dtype=wire
            )
        return StaleMixing(
            delay=int(args[0]) if args else 1, topology=topology,
            wire_dtype=wire,
        )
    except ValueError as e:
        # int()/float() parse failures and constructor validation errors,
        # re-raised with the offending spec attached.
        raise ValueError(f"bad consensus policy spec {spec!r}: {e}") from e
