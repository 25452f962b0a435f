"""ConsensusPolicy: one strategy object per way of reaching consensus.

Port of the parts of ``repro/core/policy.py`` the training slice runs:
the :class:`ConsensusContext` collectives, the :class:`ConsensusPolicy`
protocol with its eq.-15 accounting, :class:`ExactMean`, the paper's
gossip (:class:`Gossip` over any :mod:`repro_torch.core.topology` graph,
and :func:`RingGossip`, its circular alias), the non-ideal links of the
paper's §IV (:class:`QuantizedGossip`, :class:`LossyGossip`,
:class:`StaleMixing`) and the spec grammar (:func:`parse_policy`).

The paper's Algorithm 1 is parameterized by *how* the workers average;
everything else is invariant.  A policy's ``mix(x, state, ctx)`` runs
inside the worker program and communicates only through ``ctx``.  In the
port the M workers are the leading dimension of a tensor, ``(M, ...)``,
so a collective is a reduction over dim 0 whose result every worker
sees, and a ``ppermute`` hop is a gather over dim 0.

==================================  ==============================  ==========
policy                              exchanges/round                 wire bits
==================================  ==============================  ==========
``ExactMean()``                     1 (one all-reduce)              32
``Gossip(rounds, topology)``        rounds * topology edges         32/16
``RingGossip(rounds, degree)``      2 * degree * rounds             32/16
``QuantizedGossip(bits, ...)``      1 (or rounds * edges)           ``bits``
``LossyGossip(drop_prob, ...)``     rounds * topology edges         32/16
``StaleMixing(delay, ...)``         1 (or topology edges)           32/16
==================================  ==============================  ==========

``Gossip`` compiles its B rounds into ONE H^B mix by default
(``compress=True``; :meth:`repro_torch.core.topology.Topology.power_schedule`),
where that schedule is shallower than B serial rounds, and takes
``wire_dtype=`` (f32 / bf16 / f16 link payloads accumulated in full
precision).  The rest of the reference's family (``AsyncGossip`` and the
robust policies) waits for ROADMAP Queue 1 item 4: :func:`parse_policy`
parses their specs and raises ``NotImplementedError`` naming it.

Policies are frozen dataclasses: hashable (they key the backend's
program record), compare by value, and hold only static configuration.
Randomized policies fold a static integer ``seed`` with each worker's
index into a threefry key (:mod:`repro_torch.prng`, ``jax.random``'s
words) and advance it through the mix state, so they draw ``repro``'s
numbers.  No key depends on the data: the key chain runs on the host in
numpy, and each mix's draws for a given key are memoized (every layer's
ADMM starts the same chain), so only the bulk stochastic-rounding bits
are drawn on the device, in one batched pass a mix.
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
from repro_torch.core.topology import Ring, Topology, parse_topology

Tensor = torch.Tensor


@dataclass(frozen=True)
class ConsensusContext:
    """Collectives available to a policy inside the worker program: each
    reduces over the worker dimension (dim 0) of a stacked ``(M, ...)``
    tensor and hands every worker the result, stacked again, or (for
    ``ppermute``) moves each worker's slice to another worker."""

    num_workers: int

    def pmean(self, x: Tensor) -> Tensor:
        return x.mean(dim=0, keepdim=True).expand_as(x)

    def psum(self, x: Tensor) -> Tensor:
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def pmax(self, x: Tensor) -> Tensor:
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def ppermute(self, x: Tensor, perm) -> Tensor:
        """``out[dst] = x[src]`` for each ``(src, dst)`` pair of ``perm``,
        a permutation of the workers."""
        return consensus_lib.ppermute(x, perm)

    def worker_index(self, device: torch.device | str | None = None) -> Tensor:
        return torch.arange(self.num_workers, device=device)


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
            return consensus_lib.schedule_gossip_step(x, sched, wire_dtype=wd), state
        scheds = _cycle_schedules(self.topology, ctx)
        if len(scheds) == 1:
            # The bit-identity path for Ring (ring_gossip_average's hops).
            out = consensus_lib.schedule_gossip_average(
                x, scheds[0], self.rounds, wire_dtype=wd
            )
        else:
            out = x
            for b in range(self.rounds):
                out = consensus_lib.schedule_gossip_step(
                    out, scheds[b % len(scheds)], wire_dtype=wd
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
    parts, sizes = [], []
    for b in range(policy.rounds):
        pair = prng.split(key)
        key, sub = pair[:, 0], pair[:, 1]
        coef, wsum = consensus_lib.lossy_link_weights(
            scheds[b % len(scheds)], policy.drop_prob, sub
        )
        parts += [coef.ravel(), wsum]
        sizes.append(coef.shape)
    flat = to_device(np.concatenate(parts), device)
    rounds, offset = [], 0
    for shape in sizes:
        n = shape[0] * shape[1]
        coef = flat[offset:offset + n].view(shape)
        wsum = flat[offset + n:offset + n + num_workers]
        rounds.append((coef, wsum))
        offset += n + num_workers
    return _frozen(np.ascontiguousarray(key)), tuple(rounds)


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
            return ctx.pmean(self._quantize(x, subs[0])), key
        scheds = _cycle_schedules(self.topology, ctx)
        for b in range(self.rounds):
            q = self._quantize(x, subs[b])
            x = consensus_lib.schedule_gossip_step(
                q, scheds[b % len(scheds)], self_value=x
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
                x, scheds[b % len(scheds)], coef, wsum, wire_dtype=wd
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
            msg, sched, self_value=fresh, wire_dtype=wd
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


#: How each ``key=value`` of the unported keyed policies parses.
_KEY_PARSERS = {
    "rounds": int, "interval": int, "f": int, "tau": float,
    "drop": float, "seed": int, "fail_at": int, "straggle": int,
    "fail": _int_list, "stragglers": _int_list, "byz": _int_list, "attack": str,
}

#: The fault-grammar keys ``async`` and the robust policies share.
_FAULT_KEYS = ("drop", "seed", "fail", "fail_at", "stragglers", "straggle", "byz", "attack")

#: The ``key=value`` segments each unported keyed policy takes.
_POLICY_KEYS = {
    "async": ("rounds", "interval") + _FAULT_KEYS,
    "trimmed": ("rounds", "f") + _FAULT_KEYS,
    "median": ("rounds",) + _FAULT_KEYS,
    "clipped": ("rounds", "tau") + _FAULT_KEYS,
}


def _unported_policy(name: str, spec: str) -> NotImplementedError:
    return NotImplementedError(
        f"consensus policy {name!r} (spec {spec!r}) is not ported to "
        "repro_torch yet (ROADMAP Queue 1 item 4); the port runs exact, "
        "gossip, quantized, lossy and stale"
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
    ``key=value`` segments configure ``wire=`` and the fault keys; an
    ``@topology`` half (or ``topology=``, a ``Topology`` or a
    ``parse_topology`` spec) replaces the default ring.  ``exact``,
    ``gossip``, ``quantized``, ``lossy`` and ``stale`` build the
    reference's policies; ``async`` and the robust policies parse, then
    raise ``NotImplementedError`` naming ROADMAP Queue 1 item 4.

    >>> parse_policy("gossip:3").topology
    Ring(degree=1)
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
        if name in _POLICY_KEYS:
            # Parse the keys (and clipped's positional tau) as the
            # reference's constructors take them, then refuse.
            if name == "clipped" and "tau" in kv and args:
                raise ValueError(
                    "pass the clip radius either positionally "
                    "(clipped:0.5) or as tau=, not both"
                )
            for key in _POLICY_KEYS[name]:
                if key in kv:
                    _KEY_PARSERS[key](kv.pop(key))
            for text in args:
                float(text)
            if kv:
                raise ValueError(f"unknown {name} key(s) {sorted(kv)}")
            raise _unported_policy(name, spec)
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
