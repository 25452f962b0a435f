"""repro_torch.dssfn — the one-call facade for decentralized SSFN training.

Port of ``repro/dssfn.py`` (:class:`TrainSpec`, :func:`train`,
:func:`evaluate`) for what the port runs so far: the simulated backend
with exact consensus::

    from repro_torch import dssfn
    from repro_torch.core import ssfn

    spec = dssfn.TrainSpec(
        cfg=ssfn.SSFNConfig(input_dim=16, num_classes=6, num_layers=3,
                            hidden=64),
        workers=8,
        partition="noniid:0.75",
    )
    x_workers, t_workers = spec.partition_data(x_train, t_train)
    result = dssfn.train(spec, x_workers, t_workers, torch.Generator("cuda"))
    acc = dssfn.evaluate(result, x_test, y_test)

Training runs on the device the data lies on.  Every field of the
reference's spec is here; those whose machinery is not ported yet (other
backends and policies, topologies, membership, wire dtypes, checkpoints
and the divergence guard) raise ``NotImplementedError`` naming the
ROADMAP item that brings them, rather than being ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import layerwise as layerwise_lib
from repro_torch.core import ssfn as ssfn_lib
from repro_torch.core.backend import ConsensusBackend, SimulatedBackend
from repro_torch.core.policy import ConsensusPolicy, ExactMean

_BACKEND_KINDS = ("simulated", "mesh")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 {item}); "
        "the port trains with backend='simulated' and exact consensus"
    )


@dataclass
class TrainSpec:
    """Everything that defines a dSSFN training run except the data."""

    cfg: ssfn_lib.SSFNConfig
    backend: str | ConsensusBackend = "simulated"
    workers: int | None = None
    #: ``None``, ``"exact"`` or ``ExactMean()``.  None defers to a backend
    #: instance's own policy, else ``ExactMean``.
    policy: str | ConsensusPolicy | None = None
    topology: object | None = None
    #: Worker-shard layout ``partition_data`` uses: ``"iid"`` or
    #: ``"noniid[:alpha]"`` (``repro_torch.data.partition_by_spec``).
    partition: str = "iid"
    wire_dtype: str | None = None
    #: ADMM convergence-trace stride: 1 = every iteration, 0 = none,
    #: N > 1 = every N-th iteration.
    trace_every: int = 1
    mesh: object | None = None
    #: Self-size-estimation stop tolerance (paper §I); None = fixed depth.
    size_estimation_tol: float | None = None
    membership: object | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = False
    stop_after_layer: int | None = None
    guard_divergence: bool = False
    max_rollbacks: int = 2

    def __post_init__(self):
        if isinstance(self.backend, str):
            if self.backend not in _BACKEND_KINDS:
                raise ValueError(
                    f"unknown backend kind {self.backend!r}; expected one of "
                    f"{_BACKEND_KINDS} or a ConsensusBackend instance"
                )
            if self.backend == "mesh":
                raise _unported("backend='mesh' (MeshBackend)", "item 5")
        elif not isinstance(self.backend, SimulatedBackend):
            raise _unported(f"backend {type(self.backend).__name__}", "item 5")
        if self.mesh is not None:
            raise _unported("mesh=", "item 5")
        pol = self.policy
        if isinstance(self.backend, ConsensusBackend) and pol is None:
            pol = self.backend.policy
        if not (pol is None or pol == "exact" or isinstance(pol, ExactMean)):
            raise _unported(f"consensus policy {pol!r}", "item 4")
        if self.topology is not None:
            raise _unported("topology=", "items 3-4")
        if self.membership is not None:
            raise _unported("membership=", "item 3")
        if self.wire_dtype is not None:
            raise _unported("wire_dtype=", "item 4")
        if (
            self.checkpoint_dir is not None or self.checkpoint_every != 1
            or self.resume or self.stop_after_layer is not None
            or self.guard_divergence or self.max_rollbacks != 2
        ):
            raise _unported(
                "checkpointing, resume, stop_after_layer and the divergence "
                "guard", "item 6",
            )

    def resolve_policy(self) -> ConsensusPolicy:
        if isinstance(self.policy, ConsensusPolicy):
            return self.policy
        if self.policy is None and isinstance(self.backend, ConsensusBackend):
            return self.backend.policy
        return ExactMean()

    def resolve_backend(self) -> ConsensusBackend:
        if isinstance(self.backend, ConsensusBackend):
            return self.backend
        if self.workers is None:
            raise ValueError("simulated backend requires spec.workers")
        return SimulatedBackend(self.workers, policy=self.resolve_policy())

    def partition_data(self, x, t):
        """Shard column-stacked (P, J) data into this spec's (M, P, J/M)
        worker layout under the spec's ``partition`` scheme."""
        from repro_torch.data import partition_by_spec

        workers = self.workers
        if workers is None:
            if isinstance(self.backend, ConsensusBackend):
                workers = self.backend.num_workers
            else:
                raise ValueError(
                    "partition_data needs spec.workers (or a backend "
                    "instance that knows its worker count)"
                )
        return partition_by_spec(x, t, workers, self.partition)


class TrainResult(NamedTuple):
    params: ssfn_lib.SSFNParams
    log: layerwise_lib.LayerwiseLog
    backend: ConsensusBackend
    policy: ConsensusPolicy
    spec: TrainSpec


def train(
    spec: TrainSpec,
    x_workers: torch.Tensor,
    t_workers: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    r: Sequence[torch.Tensor] | None = None,
) -> TrainResult:
    """Run layer-wise consensus-ADMM training as described by ``spec``.

    x_workers: (M, P, J_m) column-stacked inputs per worker.
    t_workers: (M, Q, J_m) one-hot targets per worker.
    generator / r: the shared random matrices {R_l}, drawn from the
        generator or given (see ``layerwise.train_decentralized_ssfn``).
    """
    backend = spec.resolve_backend()
    policy = spec.resolve_policy()
    if spec.workers is not None and backend.num_workers != spec.workers:
        raise ValueError(
            f"spec.workers={spec.workers} but backend has "
            f"{backend.num_workers} workers"
        )
    params, log = layerwise_lib.train_decentralized_ssfn(
        x_workers, t_workers, spec.cfg, generator, r=r,
        backend=backend,
        policy=policy,
        size_estimation_tol=spec.size_estimation_tol,
        trace_every=spec.trace_every,
    )
    return TrainResult(params=params, log=log, backend=backend, policy=policy, spec=spec)


def evaluate(result: TrainResult, x_test: torch.Tensor, labels: torch.Tensor) -> float:
    """Test accuracy of a trained run."""
    return layerwise_lib.accuracy(
        result.params, x_test, labels, result.spec.cfg.num_classes
    )
