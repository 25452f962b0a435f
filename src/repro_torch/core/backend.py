"""Consensus execution backends: where the M worker programs run.

Port of ``repro/core/backend.py`` (:class:`ConsensusBackend` and
:class:`SimulatedBackend`).  A worker program is written over stacked
``(M, ...)`` tensors and talks to peers only through the collectives on
the backend (reductions over dim 0).  :class:`SimulatedBackend` keeps all
M workers on one device as the leading dimension and calls the program
once; the reference vmaps it instead.  ``MeshBackend`` (one worker per
process over ``torch.distributed``) waits for ROADMAP Queue 1 item 5.

Program record
--------------
PyTorch runs eagerly, so there is nothing to lower or cache.  The
backend still records each distinct program it runs, keyed like the
reference's executable cache plus the operands' shapes and dtypes (the
part jit's own dispatch keys on), and reports it through
:meth:`cache_info` in the reference's schema: ``lowerings`` counts
distinct programs, ``cache_hits`` the calls of a program already seen.
An L-layer train thus reports one "lowering" per distinct layer shape,
as the reference's compile-count test asserts.
"""
from __future__ import annotations

import abc
from collections import OrderedDict
from typing import Any, Callable, Hashable

import torch

from repro_torch.core.policy import ConsensusContext, ConsensusPolicy, ExactMean

Tensor = torch.Tensor


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
        self._check_stacked(stacked_args)
        signature = (
            key if key is not None else fn,
            len(stacked_args),
            len(replicated),
            policy,
            tuple((tuple(a.shape), a.dtype) for a in (*stacked_args, *replicated)),
        )
        if signature in self._programs:
            self._programs[signature] += 1
            self.cache_hits += 1
        else:
            self._programs[signature] = 1
            self.lowerings += 1
        return fn(*stacked_args, *replicated)

    def shard_workers(self, x: Tensor) -> Tensor:
        """Place a stacked (M, ...) tensor in this backend's worker layout."""
        return x

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
            if a.shape[0] != self.num_workers:
                raise ValueError(
                    f"stacked operand has leading dim {a.shape[0]}, "
                    f"backend has {self.num_workers} workers"
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

    def describe(self) -> str:
        return (
            f"{type(self).__name__}(M={self.num_workers}, "
            f"policy={self.policy.describe()})"
        )


class SimulatedBackend(ConsensusBackend):
    """All M workers on one device, as the leading dimension of each
    tensor; a worker program runs once over the stack."""

    def __init__(self, num_workers: int, *, policy: ConsensusPolicy | None = None):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self.num_workers = int(num_workers)
        self._init_consensus(policy)
