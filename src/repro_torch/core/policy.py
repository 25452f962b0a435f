"""ConsensusPolicy: one strategy object per way of reaching consensus.

Port of the parts of ``repro/core/policy.py`` the training slice runs:
the :class:`ConsensusContext` collectives, the :class:`ConsensusPolicy`
protocol with its eq.-15 accounting, and :class:`ExactMean`.

The paper's Algorithm 1 is parameterized by *how* the workers average;
everything else is invariant.  A policy's ``mix(x, state, ctx)`` runs
inside the worker program and communicates only through ``ctx``.  In the
port the M workers are the leading dimension of a tensor, ``(M, ...)``,
so a collective is a reduction over dim 0 whose result every worker
sees.  The gossip family (``Gossip``, ``QuantizedGossip``, ...) waits for
ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Tuple

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class ConsensusContext:
    """Collectives available to a policy inside the worker program: each
    reduces over the worker dimension (dim 0) of a stacked ``(M, ...)``
    tensor and hands every worker the result, stacked again."""

    num_workers: int

    def pmean(self, x: Tensor) -> Tensor:
        return x.mean(dim=0, keepdim=True).expand_as(x)

    def psum(self, x: Tensor) -> Tensor:
        return x.sum(dim=0, keepdim=True).expand_as(x)

    def pmax(self, x: Tensor) -> Tensor:
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def worker_index(self, device: torch.device | str | None = None) -> Tensor:
        return torch.arange(self.num_workers, device=device)


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
