"""Consensus execution backends: where the M worker programs run.

Port of ``repro/core/backend.py`` (:class:`ConsensusBackend` and
:class:`SimulatedBackend`).  A worker program is written over stacked
``(M, ...)`` tensors and talks to peers only through the collectives on
the backend (reductions over dim 0).  :class:`SimulatedBackend` keeps all
M workers on one device as the leading dimension and calls the program
once; the reference vmaps it instead.  :class:`MeshBackend` runs the
program in W processes over ``torch.distributed`` (the reference's
``shard_map`` over a ``workers`` mesh): each rank holds a contiguous
block of M/W workers, and only messages and reductions cross between
ranks (:class:`repro_torch.core.policy.MeshContext`).

Program record
--------------
PyTorch runs eagerly, so there is nothing to lower or cache.  The
backend still records each distinct program it runs, keyed like the
reference's executable cache plus the operands' shapes and dtypes (the
part jit's own dispatch keys on), and reports it through
:meth:`cache_info` in the reference's schema: ``lowerings`` counts
distinct programs, ``cache_hits`` the calls of a program already seen.
An L-layer train thus reports one "lowering" per distinct layer shape,
as the reference's compile-count test asserts.  :meth:`lowering_texts`
and :meth:`lowering_stats` run a program once under
:func:`repro_torch.analysis.numerics.recording` and join the same
record, where the reference lowers without running: they return the
calls it made and the collectives the transport carried for it.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import Any, Callable, Hashable

import torch

from repro_torch.core.policy import (
    ConsensusContext,
    ConsensusPolicy,
    ExactMean,
    MeshContext,
    parse_policy,
)

Tensor = torch.Tensor


def _reject_legacy_kwargs(name: str, kwargs: dict) -> None:
    """The ``mode=`` string aliases are gone, as in the reference: fail
    with a migration hint (a clean ``TypeError``, the unknown-keyword
    contract) instead of silently accepting configuration that no longer
    does anything."""
    legacy = sorted(k for k in kwargs if k in ("mode", "degree", "num_rounds"))
    if legacy:
        raise TypeError(
            f"{name}() no longer accepts {', '.join(legacy)}: the string-"
            "mode aliases were removed. Pass policy=ExactMean() for "
            "mode='exact', policy=RingGossip(rounds=num_rounds, "
            "degree=degree) for mode='gossip', or a spec string such as "
            "'gossip:4:2' (repro_torch.core.policy.parse_policy)."
        )
    if kwargs:
        raise TypeError(
            f"{name}() got unexpected keyword argument(s) {sorted(kwargs)}"
        )


class ConsensusBackend(abc.ABC):
    """Runs worker programs on stacked ``(M, ...)`` tensors and provides
    their collectives.

    A worker program passed to :meth:`run` receives the stacked operands,
    then any ``replicated`` operands whole, and may communicate only
    through :meth:`ctx`'s collectives (or :meth:`psum`, :meth:`pmax`,
    :meth:`exact_mean`).  It returns stacked outputs.
    """

    num_workers: int
    policy: ConsensusPolicy

    def _init_consensus(self, policy: ConsensusPolicy | None) -> None:
        if policy is None:
            policy = ExactMean()
        if not isinstance(policy, ConsensusPolicy):
            raise TypeError(
                f"policy must be a ConsensusPolicy, got {type(policy).__name__}"
            )
        policy.validate(self.num_workers)
        self.policy = policy
        self._programs: OrderedDict[Hashable, int] = OrderedDict()
        self.lowerings = 0
        self.cache_hits = 0

    # Legacy attribute views over the policy (the reference's pre-policy
    # API surface).
    @property
    def mode(self) -> str:
        return self.policy.mode_name

    @property
    def degree(self) -> int:
        return getattr(self.policy, "degree", 1)

    @property
    def num_rounds(self) -> int:
        return getattr(self.policy, "rounds", 1)

    def ctx(self) -> ConsensusContext:
        """The collectives handle policies mix through."""
        return ConsensusContext(self.num_workers)

    def run(
        self,
        fn: Callable[..., Any],
        *stacked_args: Tensor,
        replicated: tuple = (),
        key: Hashable | None = None,
        policy: ConsensusPolicy | None = None,
    ) -> Any:
        """Run ``fn(*stacked_args, *replicated)``; stacked (M, ...) in and out.

        key: the program's identity, which must capture every closed-over
            value that changes what ``fn`` computes (mu, K, ...); the
            default is ``fn`` itself.
        policy: the consensus policy this program runs under, when it is
            not the backend default; part of the program's identity.
        """
        return self._call(fn, stacked_args, replicated, key, policy, collective=True)

    def map_workers(
        self,
        fn: Callable[..., Any],
        *stacked_args: Tensor,
        replicated: tuple = (),
        key: Hashable | None = None,
    ) -> Any:
        """Like :meth:`run` for a purely local ``fn``, one that makes no
        collective; on a mesh a collective in it raises."""
        return self._call(fn, stacked_args, replicated, key, None, collective=False)

    def _call(self, fn, stacked_args, replicated, key, policy, *, collective: bool):
        self._check_stacked(stacked_args)
        signature = (
            key if key is not None else fn,
            len(stacked_args),
            len(replicated),
            collective,
            policy,
            tuple((tuple(a.shape), a.dtype) for a in (*stacked_args, *replicated)),
        )
        if signature in self._programs:
            self._programs[signature] += 1
            self.cache_hits += 1
        else:
            self._programs[signature] = 1
            self.lowerings += 1
        if collective:
            return fn(*stacked_args, *replicated)
        before = self._transport_stats()
        out = fn(*stacked_args, *replicated)
        if before is not None and self._transport_delta(before)["collective_counts"]:
            raise RuntimeError(
                "a map_workers program made a collective; run it with run()"
            )
        return out

    def lowering_texts(
        self,
        fn: Callable[..., Any],
        *stacked_args: Tensor,
        replicated: tuple = (),
        key: Hashable | None = None,
        policy: ConsensusPolicy | None = None,
    ) -> dict:
        """Run the worker program once, as :meth:`run` does (it joins the
        program record the same way), under
        :func:`repro_torch.analysis.numerics.recording`, and report what
        it did: ``{"record": ..., "program": ..., "collective_counts":
        ..., "collective_bytes": ..., "collective_dtypes": ...}``.

        ``record`` is the rendered record, one line per call;
        ``program`` the :class:`~repro_torch.analysis.numerics.ProgramRecord`
        the numerics lint reads.  The collectives are what this process's
        transport carried for the program: by kind, bytes by kind, and
        ``{kind: {payload dtype: count}}``; none on a
        :class:`SimulatedBackend`, whose reductions are local, as
        ``vmap``'s collectives trace away in the reference.  The
        reference lowers without running and returns program texts; the
        port has none to return.
        """
        from repro_torch.analysis.numerics import recording

        before = self._transport_stats()
        with recording() as record:
            self.run(fn, *stacked_args, replicated=replicated, key=key, policy=policy)
        out = {"record": record.render(), "program": record}
        if before is None:
            out.update(collective_counts={}, collective_bytes={}, collective_dtypes={})
        else:
            out.update(self._transport_delta(before))
        return out

    def lowering_stats(
        self,
        fn: Callable[..., Any],
        *stacked_args: Tensor,
        replicated: tuple = (),
        key: Hashable | None = None,
        policy: ConsensusPolicy | None = None,
    ) -> dict:
        """:meth:`lowering_texts`'s numbers: ``collective_counts``,
        ``collective_bytes``, their total ``collective_wire_bytes``,
        ``collective_dtypes`` and ``call_counts``, the recorded calls by
        name."""
        texts = self.lowering_texts(
            fn, *stacked_args, replicated=replicated, key=key, policy=policy,
        )
        return {
            "collective_counts": texts["collective_counts"],
            "collective_bytes": texts["collective_bytes"],
            "collective_wire_bytes": sum(texts["collective_bytes"].values()),
            "collective_dtypes": texts["collective_dtypes"],
            "call_counts": texts["program"].counts(),
        }

    def _transport_stats(self):
        """A copy of what this process's transport has counted, or None
        where there is none."""
        return None

    @property
    def local_workers(self) -> int:
        """The workers this process holds: the leading dim of the stacked
        operands :meth:`run` takes."""
        return self.num_workers

    def shard_workers(self, x: Tensor) -> Tensor:
        """Place a stacked (M, ...) tensor in this backend's worker layout."""
        return x

    def gather_workers(self, x: Tensor) -> Tensor:
        """The full ``(M, ...)`` stack of a value this process holds a
        block of (used at a layer's end, never inside the ADMM loop)."""
        return x

    def barrier(self) -> None:
        """Return once every process of the backend has reached it."""

    @property
    def is_writer(self) -> bool:
        """Whether this process writes what the run saves (one does)."""
        return True

    def cache_info(self) -> dict:
        """Program-record counters in the reference's normalized schema:
        ``entries``/``lowerings``/``cache_hits`` plus ``keys``, the
        program keys as repr strings."""
        return {
            "entries": len(self._programs),
            "lowerings": self.lowerings,
            "cache_hits": self.cache_hits,
            "keys": [repr(k) for k in self._programs],
        }

    def _check_stacked(self, stacked_args) -> None:
        for a in stacked_args:
            if a.shape[0] != self.local_workers:
                raise ValueError(
                    f"stacked operand has leading dim {a.shape[0]}, "
                    f"backend holds {self.local_workers} workers"
                )

    # ------------------------------------------------------------------
    # Collectives over the worker dimension.
    # ------------------------------------------------------------------
    def consensus_mean(self, x: Tensor) -> Tensor:
        """The paper's graph-average primitive (Algorithm 1, line 8): one
        mix under this backend's policy, from a fresh policy state."""
        return self.policy.one_shot(x, self.ctx())

    def exact_mean(self, x: Tensor) -> Tensor:
        """True mean regardless of policy (diagnostics: consensus error)."""
        return self.ctx().pmean(x)

    def psum(self, x: Tensor) -> Tensor:
        return self.ctx().psum(x)

    def pmax(self, x: Tensor) -> Tensor:
        return self.ctx().pmax(x)

    def worker_index(self, device: torch.device | str | None = None) -> Tensor:
        """The global indices of the workers this process holds, as a
        tensor on ``device`` (the CPU by default)."""
        return self.ctx().worker_index(device)

    # ------------------------------------------------------------------
    # Communication accounting (paper eq. 15)
    # ------------------------------------------------------------------
    def exchanges_per_consensus(self) -> int:
        """Peer messages each worker sends per :meth:`consensus_mean`:
        one for the exact all-reduce (B=1 in the eq.-15 accounting), the
        topology's edges for each of B gossip rounds; the policy's
        M-aware ``exchanges_for``."""
        return self.policy.exchanges_for(self.num_workers)

    def describe(self) -> str:
        return (
            f"{type(self).__name__}(M={self.num_workers}, "
            f"policy={self.policy.describe()})"
        )


class SimulatedBackend(ConsensusBackend):
    """All M workers on one device, as the leading dimension of each
    tensor; a worker program runs once over the stack."""

    def __init__(
        self, num_workers: int, *, policy: ConsensusPolicy | None = None, **removed
    ):
        _reject_legacy_kwargs("SimulatedBackend", removed)
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = int(num_workers)
        self._init_consensus(policy)


class MeshBackend(ConsensusBackend):
    """Real SPMD workers: the program runs in every rank of a
    :class:`repro_torch.launch.mesh.WorkerGroup`, each rank on its own
    block of M/W workers.

    ``num_workers`` is the global M.  :meth:`run` takes and returns the
    rank's ``(M/W, ...)`` blocks; :meth:`shard_workers` cuts a full
    ``(M, ...)`` stack to them (and passes a block through);
    :meth:`gather_workers` all-gathers a block back to the full stack.
    ``psum``, ``pmax`` and ``exact_mean`` are collectives, and a policy's
    mix runs on :class:`~repro_torch.core.policy.MeshContext`.  The
    transport counts what it carries (:meth:`collective_counts`, named
    like the reference's ``lowering_stats``).  ``group=None`` takes
    :func:`repro_torch.launch.mesh.make_worker_group`'s default: the
    ``torchrun`` group, or one rank holding one worker.
    """

    def __init__(self, group=None, *, policy: ConsensusPolicy | None = None, **removed):
        from repro_torch.launch.mesh import WorkerGroup, make_worker_group

        _reject_legacy_kwargs("MeshBackend", removed)
        if group is None:
            group = make_worker_group()
        if not isinstance(group, WorkerGroup):
            raise TypeError(
                f"group must be a WorkerGroup (launch.mesh.make_worker_group), "
                f"got {type(group).__name__}"
            )
        self.group = group
        self.num_workers = group.num_workers
        self._init_consensus(policy)
        self._ctx = MeshContext(
            self.num_workers, rank=group.rank, ranks=group.size, transport=group.transport,
        )

    def ctx(self) -> MeshContext:
        return self._ctx

    @property
    def local_workers(self) -> int:
        return self.group.local_workers

    @property
    def rows(self) -> slice:
        """The global indices of the workers this rank holds."""
        return self.group.rows

    @property
    def is_writer(self) -> bool:
        return self.group.rank == 0

    def shard_workers(self, x: Tensor) -> Tensor:
        if x.shape[0] == self.num_workers:
            return x[self.rows]
        if x.shape[0] == self.local_workers:
            return x
        raise ValueError(
            f"stacked operand has leading dim {x.shape[0]}; this rank takes "
            f"all {self.num_workers} workers or its block of {self.local_workers}"
        )

    def gather_workers(self, x: Tensor) -> Tensor:
        return self.group.transport.all_gather(x)

    def barrier(self) -> None:
        self.group.transport.barrier()

    def collective_counts(self) -> dict:
        """Collectives this rank has issued, by kind (a gossip hop is one
        ``collective-permute``, as in the reference's lowering)."""
        return {k: v for k, v in self.group.transport.stats.counts.items() if v}

    def collective_bytes(self) -> dict:
        """Bytes this rank has put on the wire, by kind (a hop's rows that
        stay in the rank move by a local index and are not counted)."""
        return {k: v for k, v in self.group.transport.stats.bytes.items() if v}

    def reset_collective_counts(self) -> None:
        self.group.transport.reset()

    def _transport_stats(self):
        stats = self.group.transport.stats
        return dict(stats.counts), dict(stats.bytes), dict(stats.dtypes)

    def _transport_delta(self, before) -> dict:
        from repro_torch.launch.mesh import moved

        counts, nbytes, dtypes = (moved(n, b) for n, b in zip(self._transport_stats(), before))
        by_dtype: dict = {}
        for (kind, dtype), n in dtypes.items():
            by_dtype.setdefault(kind, {})[dtype] = n
        return {"collective_counts": counts, "collective_bytes": nbytes,
                "collective_dtypes": by_dtype}

    def describe(self) -> str:
        return (
            f"{type(self).__name__}(M={self.num_workers}, "
            f"policy={self.policy.describe()}, ranks={self.group.size}, "
            f"transport={self.group.transport.describe()})"
        )


def make_backend(
    kind: str,
    num_workers: int | None = None,
    *,
    mesh=None,
    policy: ConsensusPolicy | str | None = None,
    degree: int = 1,
) -> ConsensusBackend:
    """CLI-friendly factory: kind in {'simulated', 'mesh'}.

    ``policy`` is a ConsensusPolicy or a ``parse_policy`` spec string
    (``degree`` fills a ring degree the spec leaves out); ``mesh`` a
    :class:`repro_torch.launch.mesh.WorkerGroup` for the mesh backend
    (default: :func:`~repro_torch.launch.mesh.make_worker_group` of
    ``num_workers``)."""
    if isinstance(policy, str):
        policy = parse_policy(policy, degree=degree)
    if kind == "simulated":
        if num_workers is None:
            raise ValueError("simulated backend requires num_workers")
        return SimulatedBackend(num_workers, policy=policy)
    if kind == "mesh":
        if mesh is None:
            from repro_torch.launch.mesh import make_worker_group

            mesh = make_worker_group(num_workers)
        if num_workers is not None and mesh.num_workers != num_workers:
            raise ValueError(
                f"num_workers={num_workers} but the group has {mesh.num_workers} workers"
            )
        return MeshBackend(mesh, policy=policy)
    raise ValueError(f"unknown backend kind {kind!r}; expected 'simulated' or 'mesh'")
