"""repro_torch.dssfn — the one-call facade for decentralized SSFN training.

Port of ``repro/dssfn.py`` (:func:`parse_spec`, :class:`TrainSpec`,
:func:`train`, :func:`evaluate`) for what the port runs so far: the
simulated backend with exact consensus or the paper's gossip over any
graph::

    from repro_torch import dssfn
    from repro_torch.core import ssfn

    spec = dssfn.TrainSpec(
        cfg=ssfn.SSFNConfig(input_dim=16, num_classes=6, num_layers=3,
                            hidden=64),
        workers=8,
        policy="gossip:4:2",       # or a repro_torch.core.policy object
        topology="torus:2x4",      # or a core.topology.Topology object
        partition="noniid:0.75",
    )
    x_workers, t_workers = spec.partition_data(x_train, t_train)
    result = dssfn.train(spec, x_workers, t_workers, torch.Generator("cuda"))
    acc = dssfn.evaluate(result, x_test, y_test)

``policy`` accepts a policy object or a spec string in the unified
:func:`parse_spec` grammar, ``"policy[@topology]"``; ``topology`` a
:mod:`repro_torch.core.topology` object or spec string applied to the
gossip policy; ``membership`` masks its graph to the active workers
(``Masked``/``Membership``); ``wire_dtype`` narrows its link payloads.

Elastic training: ``checkpoint_dir``/``checkpoint_every``/``resume``/
``stop_after_layer`` give layer-wise checkpoints in ``repro``'s schema (a
resumed run reproduces the uninterrupted run's iterates exactly, and a
checkpoint of either package resumes in the other), and
``guard_divergence``/``max_rollbacks`` the divergence guard.

Training runs on the device the data lies on.  Every field of the
reference's spec is here.  ``backend="mesh"`` (or a ``MeshBackend``)
runs the workers in the ranks of a ``torch.distributed`` group, each on
its block of them: ``mesh=`` takes a
:func:`repro_torch.launch.mesh.make_worker_group` result, and without
one the backend joins the ``torchrun`` group or builds a one-rank group
in this process.  Each rank calls :func:`train` with the full stacks or
its block (``partition_data`` cuts the block when ``mesh`` is given)::

    group = make_worker_group(8)                      # under torchrun
    spec = dssfn.TrainSpec(cfg=cfg, backend="mesh", mesh=group, workers=8)
    result = dssfn.train(spec, *spec.partition_data(x, t), key=key)
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple, Sequence

import torch

from repro_torch.core import layerwise as layerwise_lib
from repro_torch.core import ssfn as ssfn_lib
from repro_torch.core.backend import (  # noqa: F401  (make_backend re-exported,
    ConsensusBackend,                     # as the reference's facade does)
    MeshBackend,
    SimulatedBackend,
    make_backend,
)
from repro_torch.core.consensus import canonical_wire_dtype
from repro_torch.core.policy import ConsensusPolicy, ExactMean, Gossip, parse_policy
from repro_torch.core.topology import Masked, Membership, Topology, parse_topology

_BACKEND_KINDS = ("simulated", "mesh")


def parse_spec(
    spec: str, *, degree: int = 1, rounds: int = 1
) -> ConsensusPolicy:
    """The unified consensus-spec grammar: ``policy[@topology]``.

    The policy half is the ``parse_policy`` grammar (``exact |
    gossip[:B[:d]] | quantized:bits | lossy:p[:B[:d]] | stale:delay |
    async[:key=value...] | trimmed[:key=value...] |
    median[:key=value...] | clipped[:tau][:key=value...]``, plus
    ``wire=``/fault ``key=value`` segments) and the optional
    ``@topology`` half the ``parse_topology`` grammar (``ring:d |
    torus:RxC | hypercube | geometric:r[:seed] | full``, ``+``-joined for
    time-varying cycles)::

        parse_spec("gossip:4:2")
        parse_spec("gossip:4@torus:2x4")
        parse_spec("gossip:3:wire=bf16@hypercube")

    ``degree``/``rounds`` fill spec segments left implicit (the
    launcher's ``--degree``/``--rounds`` flags).
    """
    policy_part, sep, topo_part = spec.partition("@")
    if sep and not topo_part:
        raise ValueError(f"bad consensus spec {spec!r}: empty @topology half")
    topo = parse_topology(topo_part) if sep else None
    return parse_policy(policy_part, degree=degree, rounds=rounds, topology=topo)


def apply_topology(policy: ConsensusPolicy, topology: Topology) -> ConsensusPolicy:
    """Return ``policy`` running over ``topology``.

    Gossip-family policies (anything with a ``topology`` field) are
    rebuilt with the graph swapped in; ``ExactMean`` is rejected: a
    single all-reduce has no graph (use ``Gossip`` with
    ``FullyConnected()`` for the dense-graph gossip form).
    """
    if any(f.name == "topology" for f in fields(policy)):
        return replace(policy, topology=topology)
    raise ValueError(
        f"policy {policy.describe()} does not take a topology; use a "
        "gossip-family policy (gossip / quantized / lossy / stale)"
    )


def apply_wire_dtype(policy: ConsensusPolicy, wire_dtype: str) -> ConsensusPolicy:
    """Return ``policy`` with its link payloads narrowed to ``wire_dtype``
    (``"float32" | "bfloat16" | "float16"``, or ``f32/bf16/f16``).

    Gossip-family policies (anything with a ``wire_dtype`` field) are
    rebuilt with the wire swapped in; ``ExactMean`` (the full-precision
    all-reduce baseline) is rejected.
    """
    wire_dtype = canonical_wire_dtype(wire_dtype)
    if any(f.name == "wire_dtype" for f in fields(policy)):
        return replace(policy, wire_dtype=wire_dtype)
    raise ValueError(
        f"policy {policy.describe()} does not take a wire_dtype; use a "
        "gossip-family policy (gossip / lossy / stale — quantized packs "
        "its own wire format)"
    )


@dataclass
class TrainSpec:
    """Everything that defines a dSSFN training run except the data."""

    cfg: ssfn_lib.SSFNConfig
    backend: str | ConsensusBackend = "simulated"
    workers: int | None = None
    #: ConsensusPolicy object or spec string.  None defers to the
    #: backend: a ``ConsensusBackend`` instance keeps its own policy; a
    #: backend built from a kind string gets ``ExactMean`` (or one
    #: ``Gossip`` round when ``topology`` is set).  An explicit policy
    #: always wins.
    policy: str | ConsensusPolicy | None = None
    #: Communication graph for the gossip policy: a
    #: ``repro_torch.core.topology.Topology`` object or spec string
    #: (``parse_topology`` grammar).  None keeps the policy's own graph.
    topology: str | Topology | None = None
    #: Worker-shard layout ``partition_data`` uses: ``"iid"`` or
    #: ``"noniid[:alpha]"`` (``repro_torch.data.partition_by_spec``).
    partition: str = "iid"
    #: Link payload width for the gossip policy (``"float32" |
    #: "bfloat16" | "float16"`` or ``f32/bf16/f16``); None keeps the
    #: policy's own wire.
    wire_dtype: str | None = None
    #: ADMM convergence-trace stride: 1 = every iteration, 0 = none,
    #: N > 1 = every N-th iteration.
    trace_every: int = 1
    #: The worker group of ``backend="mesh"``
    #: (``repro_torch.launch.mesh.make_worker_group``); None joins the
    #: ``torchrun`` group or builds a one-rank group in this process.
    mesh: object | None = None
    #: Self-size-estimation stop tolerance (paper §I); None = fixed depth.
    size_estimation_tol: float | None = None
    #: Elastic membership: a ``Membership`` (or a ``"1"``/``"0"`` slot
    #: string such as ``"1101"``) masking the gossip policy's graph to the
    #: active workers (``topology.Masked``).
    membership: Membership | str | None = None
    #: Checkpoint directory for elastic resume; None never touches disk.
    checkpoint_dir: str | None = None
    #: Save state after every N completed layers (requires
    #: ``checkpoint_dir``).
    checkpoint_every: int = 1
    #: Restore the latest ``checkpoint_dir`` checkpoint before training.
    resume: bool = False
    #: Complete this layer index, checkpoint, and return the partial
    #: model (the crash half of a kill/resume drill).
    stop_after_layer: int | None = None
    #: Numerical self-healing: monitor each layer solve for non-finite
    #: iterates / objective blow-up, and on divergence roll back to the
    #: last complete checkpoint with a perturbed RNG key instead of
    #: crashing (``layerwise.train_decentralized_ssfn``).
    guard_divergence: bool = False
    #: Divergence-rollback budget (RuntimeError once spent).
    max_rollbacks: int = 2

    def __post_init__(self):
        if isinstance(self.backend, str):
            if self.backend not in _BACKEND_KINDS:
                raise ValueError(
                    f"unknown backend kind {self.backend!r}; expected one of "
                    f"{_BACKEND_KINDS} or a ConsensusBackend instance"
                )
        elif not isinstance(self.backend, ConsensusBackend):
            raise TypeError(
                f"backend must be a kind string or a ConsensusBackend, got "
                f"{type(self.backend).__name__}"
            )
        if self.mesh is not None:
            from repro_torch.launch.mesh import WorkerGroup

            if not isinstance(self.mesh, WorkerGroup):
                raise TypeError(
                    "mesh= takes a WorkerGroup (launch.mesh.make_worker_group), "
                    f"got {type(self.mesh).__name__}"
                )
        # Spec errors raise here, not at train time.
        self.resolve_policy()

    def resolve_membership(self) -> Membership | None:
        if self.membership is None or isinstance(self.membership, Membership):
            return self.membership
        return Membership(tuple(c == "1" for c in self.membership))

    def resolve_topology(self) -> Topology | None:
        if self.topology is None or isinstance(self.topology, Topology):
            return self.topology
        return parse_topology(self.topology)

    def resolve_policy(self) -> ConsensusPolicy:
        topo = self.resolve_topology()
        if isinstance(self.policy, ConsensusPolicy):
            pol = self.policy
            pol = pol if topo is None else apply_topology(pol, topo)
        elif self.policy is None:
            if topo is not None:
                # Topology with no policy = one plain gossip round over
                # that graph per consensus (raise rounds via policy=).
                pol = Gossip(rounds=1, topology=topo)
            elif isinstance(self.backend, ConsensusBackend):
                pol = self.backend.policy
            else:
                pol = ExactMean()
        elif "@" in self.policy:
            # The unified spec grammar carries its own topology half.
            if topo is not None:
                raise ValueError(
                    f"policy spec {self.policy!r} already names a "
                    "'@topology'; drop spec.topology"
                )
            pol = parse_spec(self.policy)
        else:
            pol = parse_policy(self.policy, topology=topo)
        if self.wire_dtype is not None:
            pol = apply_wire_dtype(pol, self.wire_dtype)
        membership = self.resolve_membership()
        if membership is not None:
            base = getattr(pol, "topology", None)
            if base is None:
                raise ValueError(
                    f"policy {pol.describe()} does not take a topology, so "
                    "membership cannot mask its graph; use a gossip-family "
                    "policy"
                )
            pol = apply_topology(pol, Masked(base, membership))
        return pol

    def resolve_backend(self) -> ConsensusBackend:
        if isinstance(self.backend, ConsensusBackend):
            return self.backend
        if self.backend == "mesh":
            group = self.mesh
            if group is None:
                from repro_torch.launch.mesh import make_worker_group

                group = make_worker_group(self.workers)
            return MeshBackend(group, policy=self.resolve_policy())
        if self.workers is None:
            raise ValueError("simulated backend requires spec.workers")
        return SimulatedBackend(self.workers, policy=self.resolve_policy())

    def partition_data(self, x, t):
        """Shard column-stacked (P, J) data into this spec's (M, P, J/M)
        worker layout under the spec's ``partition`` scheme; with a mesh
        group (``mesh=``, or a ``MeshBackend``), only this rank's block."""
        from repro_torch.data import partition_by_spec

        workers = self.workers
        if workers is None:
            if isinstance(self.backend, ConsensusBackend):
                workers = self.backend.num_workers
            elif self.mesh is not None:
                workers = self.mesh.num_workers
            else:
                raise ValueError(
                    "partition_data needs spec.workers (or a backend "
                    "instance that knows its worker count)"
                )
        group = self.backend.group if isinstance(self.backend, MeshBackend) else self.mesh
        rows = group.rows if group is not None else None
        return partition_by_spec(x, t, workers, self.partition, rows=rows)


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
    key=None,
) -> TrainResult:
    """Run layer-wise consensus-ADMM training as described by ``spec``.

    x_workers: (M, P, J_m) column-stacked inputs per worker; on a mesh
        rank all M or the rank's block.
    t_workers: (M, Q, J_m) one-hot targets per worker (likewise).
    generator / key / r: the shared random matrices {R_l}, drawn from the
        generator or the threefry key, or given; the run's key is what a
        checkpoint stores (see ``layerwise.train_decentralized_ssfn``).
    """
    backend = spec.resolve_backend()
    policy = spec.resolve_policy()
    if spec.workers is not None and backend.num_workers != spec.workers:
        raise ValueError(
            f"spec.workers={spec.workers} but backend has "
            f"{backend.num_workers} workers"
        )
    params, log = layerwise_lib.train_decentralized_ssfn(
        x_workers, t_workers, spec.cfg, generator, r=r, key=key,
        backend=backend,
        policy=policy,
        size_estimation_tol=spec.size_estimation_tol,
        trace_every=spec.trace_every,
        checkpoint_dir=spec.checkpoint_dir,
        checkpoint_every=spec.checkpoint_every,
        resume=spec.resume,
        stop_after_layer=spec.stop_after_layer,
        guard_divergence=spec.guard_divergence,
        max_rollbacks=spec.max_rollbacks,
    )
    return TrainResult(params=params, log=log, backend=backend, policy=policy, spec=spec)


def evaluate(result: TrainResult, x_test: torch.Tensor, labels: torch.Tensor) -> float:
    """Test accuracy of a trained run."""
    return layerwise_lib.accuracy(
        result.params, x_test, labels, result.spec.cfg.num_classes
    )
