"""Layer-wise training of SSFN: centralized and decentralized (Algorithm 1).

Port of ``repro/core/layerwise.py`` on the backend path.  Both trainers
share the progressive-growth loop (paper §II-B):

  for l = 0..L:
    1. compute layer features Y_l (per worker in the decentralized case)
    2. solve the convex readout problem (6) for O_l by consensus ADMM
       (centralized = the same ADMM with M=1)
    3. form W_{l+1} = [V_Q O_l ; R_{l+1}] and continue

Each layer is one :func:`repro_torch.core.engine.fused_layer_step`, whose
Gram products go through the hand-written kernels on the card.  The
legacy ``consensus_fn=`` simulation (an arbitrary dense H,
``consensus.make_consensus_fn``) runs its own loop,
:func:`_train_consensus_fn_path`, through the same propagation and Gram
ops.  Traces stay on the device until the loop ends; the loop's host
syncs are the guarded Cholesky's one per layer and, with size
estimation, one scalar.
Checkpoint/resume, ``stop_after_layer`` and the divergence guard wait for
ROADMAP Queue 1 item 6: they are not parameters here yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import admm as admm_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import ssfn as ssfn_lib
from repro_torch.core.backend import ConsensusBackend, SimulatedBackend
from repro_torch.core.policy import ConsensusPolicy

Tensor = torch.Tensor


@dataclass
class LayerwiseLog:
    #: Objective after each layer solve; EMPTY when trace collection is
    #: disabled (``trace_every=0``).
    layer_costs: list[float]
    admm_objective: np.ndarray          # (L+1, K/N) trace (paper Fig. 3)
    admm_primal: np.ndarray
    admm_dual: np.ndarray
    consensus_error: np.ndarray
    wall_time_s: float
    comm_scalars: int                   # total scalars exchanged (eq. 15)
    #: (layers, M) guarded-Cholesky jitter level per layer solve (int32;
    #: all-zero on a numerically healthy run).
    jitter_levels: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.int32)
    )
    #: Divergence-guard rollbacks; always 0 until the guard is ported.
    rollbacks: int = 0


def _mu_for_layer(cfg: ssfn_lib.SSFNConfig, layer: int) -> float:
    return cfg.mu0 if layer == 0 else cfg.mul


def _random_matrices(cfg, generator, r, device) -> list[Tensor]:
    if (generator is None) == (r is None):
        raise ValueError(
            "pass exactly one of generator= (draw R_1..R_L) or r= (use these)"
        )
    if r is None:
        return list(ssfn_lib.init_random_matrices(cfg, generator=generator, device=device))
    r_list = [torch.as_tensor(ri).to(device, cfg.dtype) for ri in r]
    rows = cfg.n - 2 * cfg.num_classes
    want = [(rows, cfg.input_dim if l == 0 else cfg.n) for l in range(cfg.num_layers)]
    got = [tuple(ri.shape) for ri in r_list]
    if got != want:
        raise ValueError(f"r= has shapes {got}, the config needs {want}")
    return r_list


def train_decentralized_ssfn(
    x_workers: Tensor,
    t_workers: Tensor,
    cfg: ssfn_lib.SSFNConfig,
    generator: torch.Generator | None = None,
    *,
    r: Sequence[Tensor] | None = None,
    consensus_fn: Callable[[Tensor], Tensor] | None = None,
    backend: ConsensusBackend | None = None,
    policy: ConsensusPolicy | None = None,
    gossip_rounds: int = 1,
    size_estimation_tol: float | None = None,
    trace_every: int = 1,
) -> tuple[ssfn_lib.SSFNParams, LayerwiseLog]:
    """Train dSSFN on M workers, on the device ``x_workers`` lies on.

    x_workers: (M, P, J_m) column-stacked inputs per worker (disjoint shards).
    t_workers: (M, Q, J_m) one-hot targets per worker.
    generator / r: where the shared random matrices R_1..R_L come from:
        drawn from ``generator`` (``ssfn.init_random_matrices``), or given
        as ``r`` (for instance ``repro``'s, carried across as numpy
        arrays).  Exactly one is passed.
    backend: where the M workers run; None = ``SimulatedBackend(M)``.
    policy: how the workers reach consensus; defaults to the backend's.
        It also drives the eq.-15 accounting (``policy.comm_scalars``)
        when a backend or policy is passed.
    consensus_fn: the legacy dense-H consensus primitive for the
        Z-update (exclusive with ``backend``/``policy``).
    gossip_rounds: B, the eq.-15 exchanges per consensus when neither a
        backend nor a policy is passed: with ``consensus_fn``, and for
        the implicit simulated exact default (B=1 for one all-reduce).
    size_estimation_tol: the self-size-estimating stop (paper §I): stop
        growing layers once the relative cost improvement drops below
        this tolerance.  None = fixed size (``cfg.num_layers``).
    trace_every: convergence-trace stride (``engine.fused_layer_step``);
        0 carries empty traces and layer costs, and cannot be combined
        with ``size_estimation_tol``.
    """
    if consensus_fn is not None and (backend is not None or policy is not None):
        raise ValueError("pass either consensus_fn or backend/policy, not both")
    if trace_every == 0 and size_estimation_tol is not None:
        raise ValueError(
            "size_estimation_tol reads the per-layer consensus objective; "
            "it cannot be combined with trace_every=0 (no traces)"
        )
    if consensus_fn is not None:
        if trace_every != 1:
            raise ValueError(
                "trace_every is a backend-path knob; the legacy "
                "consensus_fn simulation always traces every iteration"
            )
        return _train_consensus_fn_path(
            x_workers, t_workers, cfg, generator, r=r,
            consensus_fn=consensus_fn,
            gossip_rounds=gossip_rounds,
            size_estimation_tol=size_estimation_tol,
        )
    q = cfg.num_classes
    t0 = time.perf_counter()
    r_list = _random_matrices(cfg, generator, r, x_workers.device)

    engine_backend = backend or SimulatedBackend(x_workers.shape[0])
    # The implicit simulated exact default (no backend, no policy) keeps
    # the legacy ``gossip_rounds`` accounting.
    explicit = backend is not None or policy is not None
    policy = policy if policy is not None else engine_backend.policy
    num_workers = engine_backend.num_workers
    t_workers = engine_backend.shard_workers(t_workers)
    y_workers = engine_backend.shard_workers(x_workers)   # y_0 = x

    o_list: list[Tensor] = []
    w_next: Tensor | None = None
    dev_traces = []
    jitter_list: list[np.ndarray] = []
    comm = 0
    prev_cost: float | None = None
    for layer in range(cfg.num_layers + 1):
        step = engine_lib.fused_layer_step(
            engine_backend, y_workers, t_workers, w_next,
            mu=_mu_for_layer(cfg, layer),
            eps_radius=cfg.eps_radius,
            num_iters=cfg.admm_iters,
            policy=policy,
            trace_every=trace_every,
        )
        y_workers = step.y_workers
        o_list.append(step.o_star)
        if step.trace is not None:
            dev_traces.append(step.trace)
        jitter_list.append(step.jitter.cpu().numpy())
        # Eq.-15 accounting: Q * n_{l-1} scalars per exchange, the
        # policy's exchanges per consensus, K consensus rounds per layer.
        if explicit:
            comm += policy.comm_scalars(
                scalars=q * y_workers.shape[1],
                num_consensus=cfg.admm_iters,
                num_workers=num_workers,
            )
        else:
            comm += q * y_workers.shape[1] * gossip_rounds * cfg.admm_iters
        # Self-size estimation: every worker sees the same consensus
        # objective, so the stop decision is itself consensual.
        if size_estimation_tol is not None:
            cur = float(step.trace.objective[-1])
            if (
                prev_cost is not None
                and prev_cost - cur < size_estimation_tol * max(prev_cost, 1e-12)
            ):
                break
            prev_cost = cur
        if layer < cfg.num_layers:
            w_next = ssfn_lib.build_weight(step.o_star, r_list[layer], q)

    # One fetch of every per-layer trace after the loop.
    traces = [[t.cpu().numpy() for t in tr] for tr in dev_traces]
    layer_costs = [float(tr[0][-1]) for tr in traces]

    def stacked(i: int) -> np.ndarray:
        if not traces:
            return np.zeros((len(o_list), 0), np.float32)
        return np.stack([tr[i] for tr in traces])

    # An early size-estimation stop leaves fewer readouts than matrices.
    params = ssfn_lib.SSFNParams(
        o=tuple(o_list), r=tuple(r_list[: len(o_list) - 1])
    )
    log = LayerwiseLog(
        layer_costs=layer_costs,
        admm_objective=stacked(0),
        admm_primal=stacked(1),
        admm_dual=stacked(2),
        consensus_error=stacked(3),
        wall_time_s=time.perf_counter() - t0,
        comm_scalars=comm,
        jitter_levels=np.stack(jitter_list),
    )
    return params, log


def _train_consensus_fn_path(
    x_workers: Tensor,
    t_workers: Tensor,
    cfg: ssfn_lib.SSFNConfig,
    generator: torch.Generator | None,
    *,
    r: Sequence[Tensor] | None,
    consensus_fn: Callable[[Tensor], Tensor],
    gossip_rounds: int,
    size_estimation_tol: float | None,
) -> tuple[ssfn_lib.SSFNParams, LayerwiseLog]:
    """Legacy batched dense-H simulation (arbitrary mixing matrix H).

    Each layer is ``admm.admm_ridge_consensus(consensus_fn=...)``'s solve
    (:func:`admm.consensus_fn_iterations`).  Its features and Gram come
    from the ``gram`` op at layer 0 and the ``propagate_gram`` op at every
    later layer: relu(W Y) and Y Y^T + I/mu, the reference's plain
    propagation and Gram in one call.
    """
    q = cfg.num_classes
    t0 = time.perf_counter()
    r_list = _random_matrices(cfg, generator, r, x_workers.device)

    o_list: list[Tensor] = []
    y_workers = x_workers                      # y_0 = x
    dev_traces = []
    layer_costs: list[float] = []
    comm = 0
    w_next: Tensor | None = None
    for layer in range(cfg.num_layers + 1):
        mu = _mu_for_layer(cfg, layer)
        if w_next is None:
            a, chol, _ = admm_lib._worker_stats(y_workers, t_workers, mu)
        else:
            y_workers, a, chol, _ = engine_lib._propagate_and_stats(
                w_next, y_workers, t_workers, mu
            )
        z_init = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
        (_, o_l, _), traces = admm_lib.consensus_fn_iterations(
            a, chol, y_workers, t_workers, z_init, consensus_fn=consensus_fn,
            mu=mu, eps_radius=cfg.eps_radius, num_iters=cfg.admm_iters,
        )
        o_list.append(o_l)
        dev_traces.append(traces)
        comm += q * y_workers.shape[1] * gossip_rounds * cfg.admm_iters
        if size_estimation_tol is not None:
            layer_costs.append(float(traces[0][-1]))
            if (
                len(layer_costs) >= 2
                and layer_costs[-2] - layer_costs[-1]
                < size_estimation_tol * max(layer_costs[-2], 1e-12)
            ):
                break
        if layer < cfg.num_layers:
            w_next = ssfn_lib.build_weight(o_l, r_list[layer], q)

    # One fetch of every per-layer trace after the loop.
    traces = [[t.cpu().numpy() for t in tr] for tr in dev_traces]
    params = ssfn_lib.SSFNParams(
        o=tuple(o_list), r=tuple(r_list[: len(o_list) - 1])
    )
    log = LayerwiseLog(
        layer_costs=[float(tr[0][-1]) for tr in traces],
        admm_objective=np.stack([tr[0] for tr in traces]),
        admm_primal=np.stack([tr[1] for tr in traces]),
        admm_dual=np.stack([tr[2] for tr in traces]),
        consensus_error=np.stack([tr[3] for tr in traces]),
        wall_time_s=time.perf_counter() - t0,
        comm_scalars=comm,
    )
    return params, log


def train_centralized_ssfn(
    x: Tensor,
    t: Tensor,
    cfg: ssfn_lib.SSFNConfig,
    generator: torch.Generator | None = None,
    *,
    r: Sequence[Tensor] | None = None,
) -> tuple[ssfn_lib.SSFNParams, LayerwiseLog]:
    """Centralized SSFN = the same loop with all data on one worker (M=1)."""
    return train_decentralized_ssfn(x[None], t[None], cfg, generator, r=r)


def accuracy(params: ssfn_lib.SSFNParams, x: Tensor, labels: Tensor, q: int) -> float:
    pred = ssfn_lib.classify(params, x, q)
    return float((pred == labels.to(pred.device)).float().mean())
