"""Communication-network topologies as first-class strategy objects.

The paper models the synchronous worker network as a doubly-stochastic
mixing matrix H over an arbitrary graph (no master node, §III).  This
module makes the graph itself the primary configuration axis: a
:class:`Topology` is a hashable value object that yields

1. its doubly-stochastic mixing matrix ``mixing_matrix(M)`` plus the
   analysis that governs gossip convergence — ``spectral_gap(M)``,
   ``rounds_for_tolerance(M, tol)``, ``edges_per_node(M)`` — and
2. a static **exchange schedule** ``exchange_schedule(M)``: an ordered
   sequence of ``(permutation, weight)`` steps such that one synchronous
   gossip round ``x <- H x`` is exactly

       x' = self_weight * x + sum_k weight_k * ppermute(x, perm_k)

   i.e. the dense H expressed as permutation hops that the
   gossip-family :mod:`repro_torch.core.policy` objects execute inside
   the worker program (on the simulated backend, a gather over the
   worker dimension of a stacked ``(M, ...)`` tensor).

For vertex-transitive graphs (:class:`Ring`, :class:`Torus`,
:class:`Hypercube`, :class:`FullyConnected`) the schedule is built
directly from the neighbour offsets with equal weights 1/|N_i| (the
paper's H).  For irregular graphs (:class:`RandomGeometric` with
Metropolis-Hastings weights) the schedule is derived from H by a
Birkhoff-von-Neumann decomposition — every doubly-stochastic matrix is a
convex combination of permutation matrices, so *any* H compiles to a
static ppermute schedule.  :class:`TimeVarying` cycles a tuple of
topologies across gossip rounds (B-periodic time-varying graphs).

The paper's experiments use the circular topology (:class:`Ring`); the
legacy numpy helpers (``circular_mixing_matrix`` & co.) remain as the
reference constructions the strategy objects and tests validate against.

Port of ``repro/core/topology.py``, line for line: float64 numpy (and
scipy's bipartite matching for the Birkhoff path), no torch.  The
schedules, weights and Birkhoff permutations, in their order, are the
reference's.
"""
from __future__ import annotations

import abc
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

#: Default tolerance for doubly-stochastic validation.
_DS_TOL = 1e-9

#: Pair list of one ppermute step: ``(source, destination)`` device pairs.
Permutation = tuple[tuple[int, int], ...]


def check_doubly_stochastic(h: np.ndarray, what: str = "mixing matrix") -> np.ndarray:
    """Validate that H is square, non-negative and doubly stochastic.

    Raises ``ValueError`` (NOT ``assert``, which vanishes under
    ``python -O``) so malformed matrices fail loudly in production too.
    """
    h = np.asarray(h, dtype=np.float64)
    if h.ndim != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"{what} must be square, got shape {h.shape}")
    if np.any(h < -_DS_TOL):
        raise ValueError(f"{what} has negative entries (min {h.min():.3e})")
    if not np.allclose(h.sum(axis=0), 1.0, atol=1e-8):
        raise ValueError(f"{what} columns do not sum to 1: {h.sum(axis=0)}")
    if not np.allclose(h.sum(axis=1), 1.0, atol=1e-8):
        raise ValueError(f"{what} rows do not sum to 1: {h.sum(axis=1)}")
    return h


class ExchangeSchedule(NamedTuple):
    """One gossip round ``x <- H x`` as static collective-permute steps.

    ``perms[k]`` is a ppermute pair list ``((src, dst), ...)`` — every
    worker both sends and receives exactly once per step — applied with
    weight ``weights[k]``; the worker's own value enters with
    ``self_weight``.  Equivalently ``H = self_weight * I + sum_k
    weights[k] * P_k`` with ``P_k[dst, src] = 1``.
    """

    num_workers: int
    perms: tuple[Permutation, ...]
    weights: tuple[float, ...]
    self_weight: float

    @property
    def uniform(self) -> bool:
        """True when self and every neighbour share weight 1/(k+1) — the
        paper's equal-weight rule h_ij = 1/|N_i|.  Uniform schedules run
        the cheaper sum-then-divide form (bit-identical to the ring
        hops of ``consensus.ring_gossip_step``)."""
        w = 1.0 / (len(self.perms) + 1)
        return self.self_weight == w and all(x == w for x in self.weights)

    def as_matrix(self) -> np.ndarray:
        """The dense doubly-stochastic H this schedule implements."""
        h = np.eye(self.num_workers) * self.self_weight
        for perm, w in zip(self.perms, self.weights):
            for src, dst in perm:
                h[dst, src] += w
        return check_doubly_stochastic(h, "exchange-schedule matrix")

    def compose(self, other: "ExchangeSchedule") -> "ExchangeSchedule":
        """The schedule applying ``self``'s round, then ``other``'s.

        A B-round gossip is mathematically ONE mix with the product
        matrix, so composing compiles ``other.as_matrix() @
        self.as_matrix()`` back into permutation hops via the
        Birkhoff-von-Neumann path — the depth of the result is bounded
        by the support of the product, not by the sum of the two hop
        counts.
        """
        if self.num_workers != other.num_workers:
            raise ValueError(
                f"cannot compose schedules over {self.num_workers} and "
                f"{other.num_workers} workers"
            )
        return birkhoff_schedule(other.as_matrix() @ self.as_matrix())

    def compress(self) -> "ExchangeSchedule":
        """Recompile this schedule into a minimal-depth equivalent.

        Round-trips the dense H through the Birkhoff-von-Neumann path,
        which merges duplicate permutations and peels the largest
        possible self-weight — useful after :meth:`compose` chains.
        The result implements the same H (to float64 tolerance), not
        necessarily the same hop sequence.
        """
        return birkhoff_schedule(self.as_matrix())


def _shift_perm(m: int, offsets: np.ndarray) -> Permutation:
    """Pair list sending worker i's value to worker ``i + offset`` (per-node
    offsets must form a permutation of 0..m-1)."""
    dsts = [int(d) for d in offsets]
    if sorted(dsts) != list(range(m)):
        raise ValueError(f"offsets {dsts} are not a permutation of 0..{m - 1}")
    return tuple((i, dsts[i]) for i in range(m))


def _uniform_schedule(m: int, perms: list[Permutation]) -> ExchangeSchedule:
    """Equal-weight schedule over deduplicated neighbour permutations."""
    unique: list[Permutation] = []
    for p in perms:
        if p not in unique:
            unique.append(p)
    w = 1.0 / (len(unique) + 1)
    return ExchangeSchedule(
        num_workers=m,
        perms=tuple(unique),
        weights=(w,) * len(unique),
        self_weight=w,
    )


class Topology(abc.ABC):
    """Strategy object for the worker communication graph.

    Implementations are frozen dataclasses holding only static
    configuration: hashable, compare by value, and safe to embed in
    gossip policies (which ride in the backend's program keys).  All methods
    take ``num_workers`` because a topology is an M-agnostic recipe —
    the same ``Ring(degree=2)`` object serves any mesh size it validates
    against.
    """

    #: Spec-grammar name (``parse_topology`` round-trips it).
    name: str = "topology"

    def validate(self, num_workers: int) -> None:
        """Raise ValueError if this topology cannot span M workers."""
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")

    @abc.abstractmethod
    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        """The static ppermute steps of one gossip round (see module doc)."""

    @abc.abstractmethod
    def edges_per_node(self, num_workers: int | None = None) -> int:
        """Peer messages each worker sends per gossip round (|N_i| - 1).

        The eq.-15 accounting unit.  Topologies whose degree depends on
        the graph size raise ValueError when ``num_workers`` is None.
        """

    def cycle(self) -> tuple["Topology", ...]:
        """Per-round topology sequence; length > 1 only for TimeVarying."""
        return (self,)

    def mixing_matrix(self, num_workers: int) -> np.ndarray:
        """Dense doubly-stochastic H (validated) — by construction the
        matrix the exchange schedule implements, so the two can never
        drift apart."""
        self.validate(num_workers)
        return self.exchange_schedule(num_workers).as_matrix()

    def power_schedule(self, num_workers: int, rounds: int) -> ExchangeSchedule:
        """ONE schedule implementing ``rounds`` gossip rounds (x <- H^B x).

        A B-round gossip with mixing matrix H is mathematically a single
        mix with ``H**B``; this computes the power once at graph-build
        time (float64) and compiles it through the Birkhoff-von-Neumann
        path, so the hop count is the number of distinct permutations in
        the *support of H^B* rather than B times the per-round hop count
        — e.g. ``Ring(2)`` at B=4 on M=8 compresses 16 serial ppermutes
        into <= M-1 weighted hops in one round.  Time-varying topologies
        compose round b's matrix ``cycle[b % L]`` in sequence.

        ``Gossip(..., compress=True)`` executes this schedule in place of
        the serial round loop; semantics are preserved up to float
        reassociation (the result equals ``H**B @ x`` to f32 tolerance).
        """
        self.validate(num_workers)
        if rounds < 1:
            raise ValueError(f"power_schedule rounds must be >= 1, got {rounds}")
        cycle = self.cycle()
        if rounds == 1 and len(cycle) == 1:
            # Nothing to compress: one round IS the native schedule.
            return self.exchange_schedule(num_workers)
        h = np.eye(num_workers)
        for b in range(rounds):
            h = cycle[b % len(cycle)].mixing_matrix(num_workers) @ h
        return birkhoff_schedule(h)

    def spectral_gap(self, num_workers: int) -> float:
        """1 - |lambda_2(H)|: governs gossip convergence speed."""
        return spectral_gap(self.mixing_matrix(num_workers))

    def rounds_for_tolerance(self, num_workers: int, tol: float = 1e-6) -> int:
        """Gossip rounds B with ||H^B - (1/M)11^T|| <= tol (Boyd et al.)."""
        return gossip_rounds_for_tolerance(self.mixing_matrix(num_workers), tol)

    def describe(self) -> str:
        return repr(self)


# ---------------------------------------------------------------- ring

@dataclass(frozen=True)
class Ring(Topology):
    """The paper's circular topology: each node talks to its ``degree``
    nearest neighbours on each side, equal weights 1/(2d+1) (§III)."""

    degree: int = 1

    name = "ring"

    def __post_init__(self):
        if self.degree < 1:
            raise ValueError(f"ring degree must be >= 1, got {self.degree}")

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if 2 * self.degree + 1 > num_workers:
            # A larger degree would wrap the ring and double-count
            # neighbours — no longer the paper's degree-d circulant H.
            raise ValueError(
                f"gossip degree {self.degree} needs 2*d+1 <= M distinct ring "
                f"neighbours but M={num_workers}"
            )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        return 2 * self.degree

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        self.validate(num_workers)
        m = num_workers
        idx = np.arange(m)
        perms: list[Permutation] = []
        # fwd-then-bwd per distance k: the exact hop order of
        # ``consensus.ring_gossip_step``, so uniform execution of this
        # schedule is bit-identical to the legacy RingGossip policy.
        for k in range(1, self.degree + 1):
            perms.append(_shift_perm(m, (idx + k) % m))
            perms.append(_shift_perm(m, (idx - k) % m))
        return _uniform_schedule(m, perms)


# --------------------------------------------------------------- torus

@dataclass(frozen=True)
class Torus(Topology):
    """2-D wraparound grid: workers laid out row-major on a ``rows x
    cols`` torus, each talking to its 4 axis neighbours (2 when an axis
    has length 2 and both directions meet the same node)."""

    rows: int
    cols: int

    name = "torus"

    def __post_init__(self):
        if self.rows < 2 or self.cols < 2:
            raise ValueError(
                f"torus needs rows, cols >= 2, got {self.rows}x{self.cols}"
            )

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if self.rows * self.cols != num_workers:
            raise ValueError(
                f"torus {self.rows}x{self.cols} covers {self.rows * self.cols} "
                f"workers, mesh has {num_workers}"
            )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        return (1 if self.rows == 2 else 2) + (1 if self.cols == 2 else 2)

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        self.validate(num_workers)
        m = num_workers
        r = np.arange(m) // self.cols
        c = np.arange(m) % self.cols
        perms = []
        for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            dsts = ((r + dr) % self.rows) * self.cols + (c + dc) % self.cols
            perms.append(_shift_perm(m, dsts))
        # A length-2 axis makes +1 and -1 the same permutation; the
        # dedup in _uniform_schedule keeps H a simple-graph mixing
        # matrix (|N_i| = edges_per_node + 1).
        return _uniform_schedule(m, perms)


# ----------------------------------------------------------- hypercube

@dataclass(frozen=True)
class Hypercube(Topology):
    """log2(M)-dimensional hypercube: neighbours differ in one bit of the
    worker index.  Diameter log2(M) with only log2(M) edges per node —
    the classic low-diameter gossip graph (cf. D-PSGD / Bagua)."""

    name = "hypercube"

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if num_workers < 2 or num_workers & (num_workers - 1):
            raise ValueError(
                f"hypercube needs a power-of-two worker count, got {num_workers}"
            )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        if num_workers is None:
            raise ValueError(
                "hypercube degree is log2(M); pass num_workers "
                "(use exchanges_for(M) on the policy)"
            )
        self.validate(num_workers)
        return num_workers.bit_length() - 1

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        self.validate(num_workers)
        m = num_workers
        dims = m.bit_length() - 1
        idx = np.arange(m)
        perms = [_shift_perm(m, idx ^ (1 << b)) for b in range(dims)]
        return _uniform_schedule(m, perms)


# ------------------------------------------------------ fully connected

@dataclass(frozen=True)
class FullyConnected(Topology):
    """Complete graph with uniform weights 1/M: one gossip round IS the
    exact mean (H = (1/M) 11^T), at the cost of M-1 peer messages —
    the gossip-form limit that ``ExactMean``'s single all-reduce
    collapses into one collective."""

    name = "full"

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if num_workers < 2:
            raise ValueError("fully-connected topology needs M >= 2")

    def edges_per_node(self, num_workers: int | None = None) -> int:
        if num_workers is None:
            raise ValueError(
                "fully-connected degree is M-1; pass num_workers "
                "(use exchanges_for(M) on the policy)"
            )
        return num_workers - 1

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        self.validate(num_workers)
        m = num_workers
        idx = np.arange(m)
        perms = [_shift_perm(m, (idx + k) % m) for k in range(1, m)]
        return _uniform_schedule(m, perms)


# ------------------------------------------------------ random geometric

@dataclass(frozen=True)
class RandomGeometric(Topology):
    """Random geometric graph with Metropolis-Hastings doubly-stochastic
    weights (one of the alternative topologies mentioned in paper §III).

    The weights are non-uniform, so the exchange schedule comes from the
    Birkhoff-von-Neumann decomposition of H rather than neighbour
    offsets — the general path that compiles *any* doubly-stochastic
    matrix into static ppermute steps.
    """

    radius: float = 0.5
    seed: int = 0

    name = "geometric"

    def __post_init__(self):
        if not 0.0 < self.radius:
            raise ValueError(f"geometric radius must be > 0, got {self.radius}")

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if num_workers < 2:
            raise ValueError("random-geometric topology needs M >= 2")

    def mixing_matrix(self, num_workers: int) -> np.ndarray:
        self.validate(num_workers)
        return random_geometric_mixing_matrix(
            num_workers, radius=self.radius, seed=self.seed
        )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        if num_workers is None:
            raise ValueError(
                "random-geometric degree depends on the sampled graph; pass "
                "num_workers (use exchanges_for(M) on the policy)"
            )
        h = self.mixing_matrix(num_workers)
        offdiag = (h > 0) & ~np.eye(num_workers, dtype=bool)
        # Metropolis graphs are irregular: account the worst-case node.
        return int(offdiag.sum(axis=1).max())

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        return birkhoff_schedule(self.mixing_matrix(num_workers))


# --------------------------------------------------------- time-varying

@dataclass(frozen=True)
class TimeVarying(Topology):
    """B-periodic time-varying graph: gossip round b uses
    ``schedule[b % len(schedule)]``.  ``mixing_matrix`` is the one-cycle
    product H_{L-1} ... H_0 (doubly stochastic, generally asymmetric);
    per-round matrices come from ``cycle()``."""

    schedule: tuple[Topology, ...]

    name = "timevarying"

    def __post_init__(self):
        if not self.schedule:
            raise ValueError("time-varying topology needs >= 1 phase")
        for t in self.schedule:
            if not isinstance(t, Topology):
                raise TypeError(f"schedule entries must be Topology, got {t!r}")
            if isinstance(t, TimeVarying):
                raise ValueError("time-varying topologies do not nest")

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        for t in self.schedule:
            t.validate(num_workers)

    def cycle(self) -> tuple[Topology, ...]:
        return self.schedule

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        raise ValueError(
            "time-varying topology has one schedule per round; iterate "
            "cycle() (gossip-family policies do this automatically)"
        )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        # Worst round of the cycle — the per-round accounting a policy
        # refines by summing over its actual round sequence.
        return max(t.edges_per_node(num_workers) for t in self.schedule)

    def mixing_matrix(self, num_workers: int) -> np.ndarray:
        self.validate(num_workers)
        h = np.eye(num_workers)
        for t in self.schedule:
            h = t.mixing_matrix(num_workers) @ h
        return check_doubly_stochastic(h, "time-varying cycle matrix")

    def spectral_gap(self, num_workers: int) -> float:
        # Per-round-equivalent rate: the cycle contracts like
        # |lambda_2(H_cycle)|, i.e. lambda_2^(1/L) per round.
        gap_cycle = spectral_gap(self.mixing_matrix(num_workers))
        lam = (1.0 - gap_cycle) ** (1.0 / len(self.schedule))
        return float(1.0 - lam)


# ------------------------------------------- Birkhoff-von-Neumann path

def _bottleneck_matching(rem: np.ndarray, tol: float) -> np.ndarray | None:
    """Perfect matching on ``rem``'s support maximizing the MINIMUM
    matched entry (binary search over entry thresholds).

    Returns ``cols`` with ``cols[row]`` the matched column, or None when
    even the full support admits no perfect matching (possible only
    through float drift; callers bound the residual instead).  The
    bottleneck criterion extracts the largest possible weight each
    Birkhoff step, so dense powers H^B decompose without ever matching
    through near-zero entries (where the old max-mass greedy got stuck).
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    def match_at(threshold: float) -> np.ndarray | None:
        cols = maximum_bipartite_matching(
            csr_matrix(rem >= threshold), perm_type="column"
        )
        return None if (cols < 0).any() else cols

    vals = np.unique(rem[rem > tol])
    if len(vals) == 0:
        return None
    best = match_at(vals[0])  # the full (positive) support
    if best is None:
        return None
    lo, hi = 1, len(vals) - 1
    while lo <= hi:
        mid = (lo + hi) // 2
        cols = match_at(vals[mid])
        if cols is not None:
            best, lo = cols, mid + 1
        else:
            hi = mid - 1
    return best


def birkhoff_decomposition(
    h: np.ndarray, tol: float = 1e-9
) -> tuple[list[np.ndarray], list[float]]:
    """Decompose doubly-stochastic H into sum_k w_k P_k (permutations).

    Greedy Birkhoff with a bottleneck rule: repeatedly extract the
    perfect matching (guaranteed to exist on the support by Birkhoff's
    theorem / Hall's condition) that maximizes its smallest entry, with
    weight = that entry.  Each step zeroes at least one support cell, so
    it terminates in at most nnz(H) steps, and the weights come off in
    decreasing order — the minimal-depth compilation the compressed
    gossip schedules rely on.  Returns permutation matrices with
    ``P[dst, src] = 1`` and their weights (summing to 1).
    """
    h = check_doubly_stochastic(h, "Birkhoff input")
    m = h.shape[0]
    rem = h.copy()
    perms: list[np.ndarray] = []
    weights: list[float] = []
    for _ in range(m * m):
        if rem.max() <= tol:
            break
        cols = _bottleneck_matching(rem, tol)
        if cols is None:
            # Float drift broke Hall's condition on the leftover mass;
            # acceptable only if that mass is negligible (checked below).
            break
        rows = np.arange(m)
        w = float(rem[rows, cols].min())
        p = np.zeros_like(h)
        p[rows, cols] = 1.0
        perms.append(p)
        weights.append(w)
        rem[rows, cols] -= w
    if rem.max() > 1e-7:
        raise ValueError(
            f"Birkhoff decomposition left residual mass {rem.max():.3e}"
        )
    return perms, weights


def birkhoff_schedule(h: np.ndarray, tol: float = 1e-9) -> ExchangeSchedule:
    """Compile an arbitrary doubly-stochastic H into an ExchangeSchedule.

    The identity component (every node keeps min_i h_ii of its own value)
    is peeled off first so it becomes the schedule's ``self_weight``
    rather than a wasted self-ppermute; the remainder is Birkhoff-
    decomposed into weighted permutation steps.
    """
    h = check_doubly_stochastic(h)
    m = h.shape[0]
    self_w = float(np.diag(h).min())
    rem = h - self_w * np.eye(m)
    perms: tuple[Permutation, ...] = ()
    weights: tuple[float, ...] = ()
    if 1.0 - self_w > tol:
        # rem / (1 - self_w) is doubly stochastic, so Birkhoff applies.
        mats, ws = birkhoff_decomposition(rem / (1.0 - self_w), tol=tol)
        perms = tuple(
            tuple((int(src), int(dst)) for dst, src in zip(*np.nonzero(p)))
            for p in mats
        )
        weights = tuple(float(w) * (1.0 - self_w) for w in ws)
    return ExchangeSchedule(
        num_workers=m, perms=perms, weights=weights, self_weight=self_w
    )


@functools.lru_cache(maxsize=256)
def compressed_schedule(
    topology: Topology, num_workers: int, rounds: int
) -> ExchangeSchedule:
    """Memoized :meth:`Topology.power_schedule`.

    Gossip policies call this on every mix, and the Birkhoff
    decomposition of H^B is pure graph-build work
    — topologies are frozen value objects, so (topology, M, B) keys it
    exactly.
    """
    return topology.power_schedule(num_workers, rounds)


@functools.lru_cache(maxsize=512)
def cached_exchange_schedule(
    topology: Topology, num_workers: int
) -> ExchangeSchedule:
    """Memoized :meth:`Topology.exchange_schedule` — the per-round
    counterpart of :func:`compressed_schedule`, for the per-mix call
    sites in the gossip policies (irregular graphs pay a Birkhoff
    decomposition per construction)."""
    return topology.exchange_schedule(num_workers)


# -------------------------------------------------- elastic membership

def is_inverse_closed(schedule: ExchangeSchedule, tol: float = 1e-9) -> bool:
    """True iff every weighted permutation step has a matching inverse
    step at equal total weight (H = H^T as a weighted multiset of hops).

    This is the structural condition under which the on-the-fly fault
    renormalization in ``consensus.faulty_schedule_gossip_step`` stays
    *mean-preserving on the up set*: symmetric alive-gating kills the
    (i -> j) and (j -> i) weights together, so the realized matrix loses
    row and column mass identically and rerouting it to the diagonal
    keeps both sums at 1.  All uniform vertex-transitive schedules
    (``Ring``/``Torus``/``Hypercube``/``FullyConnected``) are inverse
    closed; Birkhoff-compiled schedules of asymmetric H are generally
    not, which is why fault-running policies validate this up front.
    """
    steps: dict[Permutation, float] = {}
    for perm, w in zip(schedule.perms, schedule.weights):
        canon = tuple(sorted(perm))
        steps[canon] = steps.get(canon, 0.0) + float(w)
    for canon, w in steps.items():
        inv = tuple(sorted((dst, src) for src, dst in canon))
        if abs(steps.get(inv, 0.0) - w) > tol:
            return False
    return True


def symmetrized_schedule(schedule: ExchangeSchedule) -> ExchangeSchedule:
    """Inverse-closed equivalent of a schedule implementing a SYMMETRIC H.

    Birkhoff decompositions pick arbitrary permutations, so even a
    symmetric matrix can compile to an asymmetric hop multiset (failing
    :func:`is_inverse_closed` and with it the fault-renormalization
    mean-preservation condition).  Splitting every hop into
    ``(P, w/2) + (P^-1, w/2)`` sums to the same H whenever H = H^T and is
    inverse-closed by construction; duplicate steps merge so symmetric
    permutations don't double the depth.
    """
    steps: dict[Permutation, float] = {}
    for perm, w in zip(schedule.perms, schedule.weights):
        canon = tuple(sorted(perm))
        inv = tuple(sorted((dst, src) for src, dst in canon))
        steps[canon] = steps.get(canon, 0.0) + float(w) / 2.0
        steps[inv] = steps.get(inv, 0.0) + float(w) / 2.0
    return ExchangeSchedule(
        num_workers=schedule.num_workers,
        perms=tuple(steps.keys()),
        weights=tuple(steps.values()),
        self_weight=schedule.self_weight,
    )


@dataclass(frozen=True)
class Membership:
    """Active-worker mask for elastic membership (join/leave).

    A value object over a FIXED worker-slot count M: ``active[i]`` says
    whether slot ``i`` currently participates in consensus.  The worker
    program always spans all M slots (the worker stack does not resize);
    membership only re-weights the mixing matrix via :class:`Masked`, so
    join/leave is a new policy value — one program per membership.
    """

    active: tuple[bool, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "active", tuple(bool(a) for a in self.active)
        )
        if not self.active:
            raise ValueError("membership needs >= 1 worker slot")
        if not any(self.active):
            raise ValueError("membership needs >= 1 active worker")

    @classmethod
    def all(cls, num_workers: int) -> "Membership":
        """Everyone present — the identity membership."""
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        return cls((True,) * num_workers)

    @property
    def num_workers(self) -> int:
        return len(self.active)

    @property
    def num_active(self) -> int:
        return sum(self.active)

    def without(self, *workers: int) -> "Membership":
        """The membership after the given worker slots leave."""
        gone = {self._check_index(i) for i in workers}
        return Membership(
            tuple(a and i not in gone for i, a in enumerate(self.active))
        )

    def rejoin(self, *workers: int) -> "Membership":
        """The membership after the given worker slots come back."""
        back = {self._check_index(i) for i in workers}
        return Membership(
            tuple(a or i in back for i, a in enumerate(self.active))
        )

    def _check_index(self, i: int) -> int:
        i = int(i)
        if not 0 <= i < len(self.active):
            raise ValueError(
                f"worker index {i} out of range for {len(self.active)} slots"
            )
        return i

    def mask(self) -> np.ndarray:
        """(M,) float 0/1 mask, active slots 1."""
        return np.asarray(self.active, dtype=np.float64)

    def describe(self) -> str:
        return "".join("1" if a else "0" for a in self.active)


@dataclass(frozen=True)
class Masked(Topology):
    """Membership-masked topology: ``base``'s graph restricted to the
    active workers.

    The masked H keeps the base weights between active pairs, reroutes
    every masked-out weight onto the diagonal, and leaves inactive
    workers with an identity row — they hold their value and contribute
    nothing.  For a symmetric base H (every equal-weight topology here)
    the result is doubly stochastic over all M slots AND over the active
    subset, so gossip under a ``Masked`` graph preserves the mean *of
    the active workers* exactly: double stochasticity survives
    join/leave by construction.  The schedule is compiled through the
    Birkhoff-von-Neumann path, so membership changes cost one new
    (policy, schedule) program entry.
    """

    base: Topology
    membership: Membership

    name = "masked"

    def __post_init__(self):
        if not isinstance(self.base, Topology):
            raise TypeError(
                f"base must be a Topology, got {type(self.base).__name__}"
            )
        if isinstance(self.base, TimeVarying):
            raise ValueError(
                "mask the phases of a time-varying cycle individually; "
                "Masked wraps a single-graph topology"
            )
        if not isinstance(self.membership, Membership):
            raise TypeError(
                "membership must be a Membership, got "
                f"{type(self.membership).__name__}"
            )

    def validate(self, num_workers: int) -> None:
        super().validate(num_workers)
        if self.membership.num_workers != num_workers:
            raise ValueError(
                f"membership spans {self.membership.num_workers} worker "
                f"slots, mesh has {num_workers}"
            )
        self.base.validate(num_workers)

    def _active_indices(self) -> np.ndarray:
        return np.flatnonzero(self.membership.mask())

    def mixing_matrix(self, num_workers: int) -> np.ndarray:
        self.validate(num_workers)
        h = self.base.mixing_matrix(num_workers)
        if not np.allclose(h, h.T, atol=1e-12):
            raise ValueError(
                "membership masking preserves double stochasticity only "
                "for symmetric base mixing matrices"
            )
        a = self.membership.mask()
        hm = h * np.outer(a, a)
        np.fill_diagonal(hm, np.diag(hm) + 1.0 - hm.sum(axis=1))
        return check_doubly_stochastic(hm, "membership-masked mixing matrix")

    def exchange_schedule(self, num_workers: int) -> ExchangeSchedule:
        # Masked H is symmetric by construction; symmetrize the Birkhoff
        # hops so fault gating stays mean-preserving on the active set.
        return symmetrized_schedule(
            birkhoff_schedule(self.mixing_matrix(num_workers))
        )

    def edges_per_node(self, num_workers: int | None = None) -> int:
        if num_workers is None:
            raise ValueError(
                "masked degree depends on the active set; pass num_workers "
                "(use exchanges_for(M) on the policy)"
            )
        h = self.mixing_matrix(num_workers)
        offdiag = (h > 0) & ~np.eye(num_workers, dtype=bool)
        return int(offdiag.sum(axis=1).max())

    def spectral_gap(self, num_workers: int) -> float:
        # The full-M matrix has one eigenvalue 1 per inactive worker
        # (identity rows), so the meaningful gap lives on the active
        # principal submatrix — itself doubly stochastic by construction.
        idx = self._active_indices()
        if len(idx) == 1:
            return 1.0
        h = self.mixing_matrix(num_workers)
        return spectral_gap(h[np.ix_(idx, idx)])

    def rounds_for_tolerance(self, num_workers: int, tol: float = 1e-6) -> int:
        idx = self._active_indices()
        if len(idx) == 1:
            return 1
        h = self.mixing_matrix(num_workers)
        return gossip_rounds_for_tolerance(h[np.ix_(idx, idx)], tol)


# ------------------------------------------------------------- parsing

#: Spec-name -> factory, the CLI grammar (see ``parse_topology``).
TOPOLOGIES = ("ring", "torus", "hypercube", "geometric", "full")


def parse_topology(spec: str) -> Topology:
    """CLI topology specs::

        ring[:d] | torus:RxC | hypercube | geometric:r[:seed] | full

    ``+``-joined specs build a :class:`TimeVarying` cycle, e.g.
    ``ring:1+hypercube`` alternates a sparse ring round with a hypercube
    round.

    >>> parse_topology("torus:2x4")
    Torus(rows=2, cols=4)
    >>> parse_topology("ring:2").degree
    2
    """
    if "+" in spec:
        return TimeVarying(tuple(parse_topology(s) for s in spec.split("+")))
    name, _, rest = spec.partition(":")
    args = [a for a in rest.split(":") if a] if rest else []
    try:
        if name == "ring":
            if len(args) > 1:
                raise ValueError("ring takes at most one ':d' argument")
            return Ring(degree=int(args[0]) if args else 1)
        if name == "torus":
            if len(args) != 1 or "x" not in args[0]:
                raise ValueError("torus spec is torus:RxC")
            rows, _, cols = args[0].partition("x")
            return Torus(rows=int(rows), cols=int(cols))
        if name == "hypercube":
            if args:
                raise ValueError("hypercube takes no arguments")
            return Hypercube()
        if name == "geometric":
            if not 1 <= len(args) <= 2:
                raise ValueError("geometric spec is geometric:r[:seed]")
            return RandomGeometric(
                radius=float(args[0]), seed=int(args[1]) if len(args) > 1 else 0
            )
        if name == "full":
            if args:
                raise ValueError("full takes no arguments")
            return FullyConnected()
    except ValueError as e:
        raise ValueError(f"bad topology spec {spec!r}: {e}") from e
    raise ValueError(
        f"unknown topology {name!r}; expected one of {TOPOLOGIES} (spec {spec!r})"
    )


# ------------------------------------------ legacy numpy reference API

def circular_neighbors(m: int, num_nodes: int, degree: int) -> list[int]:
    """Neighbour set N_m of node ``m`` in a degree-``d`` circular graph.

    Includes ``m`` itself (the paper has i ∈ N_i).
    """
    d_max = (num_nodes - 1) // 2 + ((num_nodes - 1) % 2)
    if degree >= d_max and num_nodes > 1:
        return list(range(num_nodes))
    out = {m}
    for k in range(1, degree + 1):
        out.add((m + k) % num_nodes)
        out.add((m - k) % num_nodes)
    return sorted(out)


def circular_mixing_matrix(num_nodes: int, degree: int) -> np.ndarray:
    """Doubly-stochastic H for a circular topology of given degree.

    Equal-weight rule from the paper: h_ij = 1/|N_i| for j in N_i, else 0.
    For a circulant graph every node has the same |N_i| so this H is
    symmetric and doubly stochastic.
    """
    if num_nodes < 1:
        raise ValueError("num_nodes must be >= 1")
    if degree < 1 and num_nodes > 1:
        raise ValueError("degree must be >= 1 for connectivity")
    h = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    for i in range(num_nodes):
        nbrs = circular_neighbors(i, num_nodes, degree)
        for j in nbrs:
            h[i, j] = 1.0 / len(nbrs)
    return check_doubly_stochastic(h, "circular mixing matrix")


def fully_connected_mixing_matrix(num_nodes: int) -> np.ndarray:
    return np.full((num_nodes, num_nodes), 1.0 / num_nodes)


def random_geometric_mixing_matrix(
    num_nodes: int, radius: float, seed: int = 0
) -> np.ndarray:
    """Metropolis-Hastings doubly-stochastic weights on a random geometric
    graph (one of the alternative topologies mentioned in paper §III)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(num_nodes, 2))
    dist = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    adj = (dist <= radius) & ~np.eye(num_nodes, dtype=bool)
    # Ensure connectivity by adding a ring.
    for i in range(num_nodes):
        adj[i, (i + 1) % num_nodes] = adj[(i + 1) % num_nodes, i] = True
    deg = adj.sum(axis=1)
    h = np.zeros((num_nodes, num_nodes))
    for i in range(num_nodes):
        for j in range(num_nodes):
            if adj[i, j]:
                h[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        h[i, i] = 1.0 - h[i].sum()
    return check_doubly_stochastic(h, "random-geometric mixing matrix")


def spectral_gap(h: np.ndarray) -> float:
    """1 - |lambda_2(H)|: governs gossip convergence speed (Boyd et al.).

    Symmetric H (every equal-weight topology here) goes through
    ``eigvalsh`` — ``eigvals`` on near-defective matrices is numerically
    unstable; the general solver only backs the asymmetric case
    (time-varying cycle products).
    """
    h = np.asarray(h, dtype=np.float64)
    if np.allclose(h, h.T, atol=1e-12):
        eig = np.sort(np.abs(np.linalg.eigvalsh(h)))[::-1]
    else:
        eig = np.sort(np.abs(np.linalg.eigvals(h)))[::-1]
    return float(1.0 - eig[1]) if len(eig) > 1 else 1.0


def gossip_rounds_for_tolerance(h: np.ndarray, tol: float = 1e-6) -> int:
    """Number of synchronous gossip rounds B so that ||H^B - (1/M)11^T|| <= tol."""
    gap = spectral_gap(h)
    if gap <= 0:
        raise ValueError("mixing matrix is not ergodic (spectral gap 0)")
    lam2 = 1.0 - gap
    if lam2 <= 0:
        return 1
    return max(1, int(np.ceil(np.log(tol) / np.log(lam2))))
