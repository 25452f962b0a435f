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
estimation or the divergence guard, one scalar.

Elastic training, as in the reference: per-layer checkpoints in
``repro``'s schema (a file written by either package resumes in the
other), ``resume``, ``stop_after_layer`` and the divergence guard, whose
rollback redraws the not-yet-consumed random matrices from
``prng.fold_in(key, 7 + rollbacks)``.  A checkpoint save fetches the
layer features to the host, the loop's one large transfer; a resume puts
the restored state on the run's device in ``cfg.dtype``.

Under a ``MeshBackend`` every rank runs this loop on its block of the
workers; each layer's readout and jitter levels come back gathered, so
every rank holds the whole model and makes the same decisions.  A
checkpoint gathers the per-worker leaves, rank 0 writes it, and every
rank resumes its own rows of it.
"""
from __future__ import annotations

import math
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import store as store_lib
from repro_torch.core import admm as admm_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core import ssfn as ssfn_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.backend import ConsensusBackend, SimulatedBackend
from repro_torch.core.policy import ConsensusPolicy

Tensor = torch.Tensor

_CKPT_PREFIX = "dssfn_layer_"
#: Checkpoint names of the ADMMTrace fields, in field order.
_TRACE_KEYS = ("obj", "primal", "dual", "cerr")


def checkpoint_path(directory: str, layer_next: int) -> str:
    """Per-layer checkpoint file: ``dssfn_layer_003.npz`` holds the full
    training state with layers 0..2 complete."""
    return os.path.join(directory, f"{_CKPT_PREFIX}{layer_next:03d}.npz")


def latest_checkpoint(directory: str) -> str | None:
    """Newest (deepest) COMPLETE checkpoint in ``directory``, or None.

    A truncated npz or an npz without its metadata sidecar (a kill
    mid-save) is skipped with a warning, and the scan falls back to the
    next-deepest checkpoint instead of handing resume a corrupt file.
    """
    if not os.path.isdir(directory):
        return None
    names = [
        f for f in os.listdir(directory)
        if f.startswith(_CKPT_PREFIX) and f.endswith(".npz")
    ]
    for name in sorted(names, reverse=True):
        path = os.path.join(directory, name)
        if store_lib.is_valid_checkpoint(path):
            return path
        warnings.warn(
            f"skipping partial/corrupt checkpoint {path!r} "
            "(interrupted save?)",
            RuntimeWarning,
            stacklevel=2,
        )
    return None


def _host(x) -> np.ndarray:
    """A tensor's host copy (or an array as it is), as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _save_checkpoint(
    directory: str, *, layer_next: int, key, y_workers, o_list,
    step: engine_lib.LayerStepResult, dev_traces, comm: int,
    prev_cost: float | None, active_mask: np.ndarray,
    r_list=None, jitter_list=None, backend: ConsensusBackend | None = None,
) -> str:
    """Elastic-resume state after ``layer_next`` completed layers, in the
    reference's schema leaf for leaf: layer features, per-layer readouts,
    the last solve's worker primals/duals, the threefry key words, the
    random matrices ACTUALLY used (a rollback redraws them, so the key
    alone no longer determines them), membership, the jitter levels and
    the traces so far.  Every leaf is fetched to the host first.  Under a
    ``MeshBackend`` every rank gathers the per-worker leaves, rank 0
    alone writes, and no rank returns before the file is complete."""
    gather = backend.gather_workers if backend is not None else (lambda x: x)
    per_worker = [gather(t) for t in (y_workers, step.o_workers, step.lam)]
    if backend is not None and not backend.is_writer:
        backend.barrier()
        return checkpoint_path(directory, layer_next)
    y_workers, o_workers, lam = per_worker
    state = {
        "layer_next": np.int64(layer_next),
        "key": prng.key_data(key),
        "y_workers": _host(y_workers),
        "o": {str(i): _host(o) for i, o in enumerate(o_list)},
        "o_workers": _host(o_workers),
        "lam": _host(lam),
        "comm": np.int64(comm),
        "prev_cost": np.float64(np.nan if prev_cost is None else prev_cost),
        "membership": np.asarray(active_mask, np.float64),
    }
    if r_list is not None:
        state["r"] = {str(i): _host(r) for i, r in enumerate(r_list)}
    if jitter_list:
        state["jit"] = np.stack([np.asarray(j, np.int32) for j in jitter_list])
    if dev_traces:
        fetched = [[_host(t) for t in tr] for tr in dev_traces]
        state["tr"] = {
            name: np.stack([tr[i] for tr in fetched])
            for i, name in enumerate(_TRACE_KEYS)
        }
    path = checkpoint_path(directory, layer_next)
    store_lib.save_pytree(path, state)
    if backend is not None:
        backend.barrier()
    return path


def _load_checkpoint(path: str, *, device: torch.device, dtype: torch.dtype) -> dict:
    """Flat checkpoint -> the resume state ``train_decentralized_ssfn``
    restores from (inverse of ``_save_checkpoint``): the features,
    readouts and random matrices on ``device`` in ``dtype``, the traces
    and jitter levels as numpy, the key as uint32 words."""
    flat = store_lib.load_pytree_flat(path)
    layer_next = int(flat["layer_next"])
    prev_cost = float(flat["prev_cost"])

    def placed(name: str) -> Tensor:
        return flat[name].to(device=device, dtype=dtype)

    traces = []
    if "tr/obj" in flat:
        fields = [flat[f"tr/{name}"].numpy() for name in _TRACE_KEYS]
        traces = [
            admm_lib.ADMMTrace(*(f[i] for f in fields))
            for i in range(fields[0].shape[0])
        ]
    r_list = None
    if "r/0" in flat:
        r_list = []
        while f"r/{len(r_list)}" in flat:
            r_list.append(placed(f"r/{len(r_list)}"))
    jitter_list = None
    if "jit" in flat:
        jitter_list = list(flat["jit"].numpy())
    return {
        "layer_next": layer_next,
        "key": prng.key_data(flat["key"]),
        "y_workers": placed("y_workers"),
        "o_list": [placed(f"o/{i}") for i in range(layer_next)],
        "comm": int(flat["comm"]),
        "prev_cost": None if math.isnan(prev_cost) else prev_cost,
        "traces": traces,
        # Checkpoints from before R and the jitter levels were stored
        # have neither: R is redrawn from the key and the jitter history
        # restarts empty.
        "r_list": r_list,
        "jitter_list": jitter_list,
    }


def _active_mask(policy: ConsensusPolicy, num_workers: int) -> np.ndarray:
    """The membership mask a checkpoint records: the ``Masked`` topology's
    active set, or all-ones for full-membership policies."""
    topo = getattr(policy, "topology", None)
    if isinstance(topo, topology_lib.Masked):
        return topo.membership.mask()
    return np.ones(num_workers, np.float64)


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
    #: Divergence-guard rollbacks taken during this run (0 = clean).
    rollbacks: int = 0


def _mu_for_layer(cfg: ssfn_lib.SSFNConfig, layer: int) -> float:
    return cfg.mu0 if layer == 0 else cfg.mul


def _step_diverged(
    step: engine_lib.LayerStepResult,
    prev_cost: float | None,
    blowup: float = 1e3,
) -> bool:
    """The divergence monitor: a non-finite consensus iterate, a
    non-finite objective, or an objective that blew up past ``blowup`` x
    the previous layer's cost.  One fetch of two scalars."""
    finite = torch.isfinite(step.o_star).all().to(torch.float64)
    if step.trace is None:
        return not bool(finite)
    obj = step.trace.objective[-1].to(device=finite.device, dtype=torch.float64)
    ok, obj = torch.stack([finite, obj]).tolist()
    if not ok or not math.isfinite(obj):
        return True
    return prev_cost is not None and obj > blowup * max(prev_cost, 1e-12)


def _check_sources(generator, r, key) -> None:
    """Exactly one source of R_1..R_L; a key may come with ``r=``."""
    if (generator is None and r is None and key is None) or (
        generator is not None and (r is not None or key is not None)
    ):
        raise ValueError(
            "pass exactly one of generator= (draw R_1..R_L), key= (draw "
            "repro's R_1..R_L from a threefry key) or r= (use these); key= "
            "may come with r="
        )


def _random_matrices(cfg, generator, r, key, device) -> list[Tensor]:
    _check_sources(generator, r, key)
    if r is None:
        return list(ssfn_lib.init_random_matrices(
            cfg, generator=generator, key=key, device=device
        ))
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
    key=None,
    consensus_fn: Callable[[Tensor], Tensor] | None = None,
    backend: ConsensusBackend | None = None,
    policy: ConsensusPolicy | None = None,
    gossip_rounds: int = 1,
    size_estimation_tol: float | None = None,
    trace_every: int = 1,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    stop_after_layer: int | None = None,
    guard_divergence: bool = False,
    max_rollbacks: int = 2,
) -> tuple[ssfn_lib.SSFNParams, LayerwiseLog]:
    """Train dSSFN on M workers, on the device ``x_workers`` lies on.

    x_workers: (M, P, J_m) column-stacked inputs per worker (disjoint shards);
        under a ``MeshBackend`` all M or the rank's block of them.
    t_workers: (M, Q, J_m) one-hot targets per worker (likewise).
    generator / key / r: where the shared random matrices R_1..R_L come
        from: drawn from ``generator`` (``ssfn.init_random_matrices``,
        PyTorch's numbers), drawn from the threefry ``key`` (a
        :mod:`repro_torch.prng` key: the reference's numbers), or given
        as ``r`` (for instance ``repro``'s, carried across as numpy
        arrays).  Exactly one is passed, except that ``key`` may come
        with ``r``.  The run's key is what a checkpoint stores and what a
        rollback perturbs: ``key``, or ``prng.PRNGKey(
        generator.initial_seed())`` for a generator run; checkpoints and
        the guard need one.
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
    checkpoint_dir: directory for elastic-resume checkpoints; None never
        touches disk.  State is saved after every ``checkpoint_every``-th
        completed layer (where ``(layer + 1) % checkpoint_every == 0``)
        and always at a ``stop_after_layer`` stop.
    resume: restore the latest ``checkpoint_dir`` checkpoint (either
        package's) and continue from its next layer; a no-op when the
        directory has none.  The resumed run reproduces the
        uninterrupted run's iterates exactly.
    stop_after_layer: complete this layer index, checkpoint, and return
        the partial model (the crash half of a kill/resume drill).
    guard_divergence: after every layer solve, check for a non-finite
        consensus iterate, a non-finite objective, or an objective
        blow-up past 1000x the previous layer's cost; on divergence roll
        back to the last complete checkpoint (or the loop's entry state
        when there is none), redraw every not-yet-consumed random matrix
        from a perturbed key, and retry.
    max_rollbacks: divergence-rollback budget; the run raises
        RuntimeError once a diverging layer has exhausted it.
    """
    if consensus_fn is not None and (backend is not None or policy is not None):
        raise ValueError("pass either consensus_fn or backend/policy, not both")
    if consensus_fn is not None and (
        checkpoint_dir is not None or resume or stop_after_layer is not None
        or guard_divergence
    ):
        raise ValueError(
            "checkpoint/resume and the divergence guard run through the "
            "backend engine path; the legacy consensus_fn simulation does "
            "not support them"
        )
    if max_rollbacks < 0:
        raise ValueError(f"max_rollbacks must be >= 0, got {max_rollbacks}")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs a checkpoint_dir to restore from")
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
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
            x_workers, t_workers, cfg, generator, r=r, key=key,
            consensus_fn=consensus_fn,
            gossip_rounds=gossip_rounds,
            size_estimation_tol=size_estimation_tol,
        )
    _check_sources(generator, r, key)
    run_key = (
        prng.key_data(key) if key is not None
        else prng.PRNGKey(generator.initial_seed()) if generator is not None
        else None
    )
    if run_key is None and (checkpoint_dir is not None or guard_divergence):
        raise ValueError(
            "checkpoints and the divergence guard need the run's PRNG key (a "
            "checkpoint stores it, a rollback redraws R from it): pass key= "
            "with r="
        )
    q = cfg.num_classes
    t0 = time.perf_counter()
    dev = x_workers.device

    engine_backend = backend or SimulatedBackend(x_workers.shape[0])
    # The implicit simulated exact default (no backend, no policy) keeps
    # the legacy ``gossip_rounds`` accounting.
    explicit = backend is not None or policy is not None
    policy = policy if policy is not None else engine_backend.policy
    num_workers = engine_backend.num_workers
    t_workers = engine_backend.shard_workers(t_workers)

    o_list: list[Tensor] = []
    w_next: Tensor | None = None
    # Per-layer traces: device tensors from this run's solves, numpy
    # arrays restored from a checkpoint; fetched once after the loop.
    dev_traces = []
    jitter_list: list[np.ndarray] = []
    comm = 0
    prev_cost: float | None = None
    layer_start = 0
    rollbacks = 0

    def restore(path: str) -> dict:
        return _load_checkpoint(path, device=dev, dtype=cfg.dtype)

    restored = None
    if resume:
        ckpt = latest_checkpoint(checkpoint_dir)
        if ckpt is not None:
            restored = restore(ckpt)
    if restored is not None:
        layer_start = restored["layer_next"]
        run_key = restored["key"]
        o_list = list(restored["o_list"])
        dev_traces = list(restored["traces"])
        jitter_list = list(restored["jitter_list"] or [])
        comm = restored["comm"]
        prev_cost = restored["prev_cost"]
        y_workers = engine_backend.shard_workers(restored["y_workers"])
        r_list = (
            list(restored["r_list"])
            if restored["r_list"] is not None
            else list(ssfn_lib.init_random_matrices(cfg, key=run_key, device=dev))
        )
        if layer_start <= cfg.num_layers:
            w_next = ssfn_lib.build_weight(o_list[-1], r_list[layer_start - 1], q)
    else:
        r_list = _random_matrices(cfg, generator, r, key, dev)
        y_workers = engine_backend.shard_workers(x_workers)   # y_0 = x

    # The divergence guard's restart point before the first checkpoint
    # exists (references only: no step writes into its inputs).
    entry_state = (
        layer_start, run_key, list(o_list), list(dev_traces), list(jitter_list),
        comm, prev_cost, y_workers, w_next, list(r_list),
    )

    layer = layer_start
    while layer <= cfg.num_layers:
        step = engine_lib.fused_layer_step(
            engine_backend, y_workers, t_workers, w_next,
            mu=_mu_for_layer(cfg, layer),
            eps_radius=cfg.eps_radius,
            num_iters=cfg.admm_iters,
            policy=policy,
            trace_every=trace_every,
        )

        if guard_divergence and _step_diverged(step, prev_cost):
            if rollbacks >= max_rollbacks:
                raise RuntimeError(
                    f"layer {layer} diverged and the rollback budget "
                    f"(max_rollbacks={max_rollbacks}) is spent"
                )
            rollbacks += 1
            ckpt = (
                latest_checkpoint(checkpoint_dir)
                if checkpoint_dir is not None else None
            )
            if ckpt is not None:
                restored = restore(ckpt)
                layer = restored["layer_next"]
                run_key = restored["key"]
                o_list = list(restored["o_list"])
                dev_traces = list(restored["traces"])
                jitter_list = list(restored["jitter_list"] or [])
                comm = restored["comm"]
                prev_cost = restored["prev_cost"]
                y_workers = engine_backend.shard_workers(restored["y_workers"])
                if restored["r_list"] is not None:
                    r_list = list(restored["r_list"])
            else:
                (layer, run_key, o_list, dev_traces, jitter_list, comm,
                 prev_cost, y_workers, w_next, r_list) = entry_state
                o_list = list(o_list)
                dev_traces = list(dev_traces)
                jitter_list = list(jitter_list)
                r_list = list(r_list)
            warnings.warn(
                f"layer solve diverged; rolling back to layer {layer} "
                f"with a perturbed key (rollback {rollbacks}/"
                f"{max_rollbacks})",
                RuntimeWarning,
                stacklevel=2,
            )
            # Perturb the key and redraw every random matrix the restart
            # point has not consumed.  r[layer-1] only feeds the NEXT
            # propagation (w_next is rebuilt below), so it is still free
            # to change; r[0..layer-2] shaped the restored features and
            # stay verbatim.
            run_key = prng.fold_in(run_key, 7 + rollbacks)
            fresh = ssfn_lib.init_random_matrices(cfg, key=run_key, device=dev)
            first_free = max(layer - 1, 0)
            r_list[first_free:] = list(fresh[first_free:])
            if layer == 0:
                w_next = None
            elif layer <= cfg.num_layers:
                w_next = ssfn_lib.build_weight(o_list[-1], r_list[layer - 1], q)
            continue

        y_workers = step.y_workers
        o_list.append(step.o_star)
        if step.trace is not None:
            dev_traces.append(step.trace)
        if step.jitter is not None:
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

        stopping = stop_after_layer is not None and layer >= stop_after_layer
        if checkpoint_dir is not None and (
            stopping or (layer + 1) % checkpoint_every == 0
        ):
            _save_checkpoint(
                checkpoint_dir, layer_next=layer + 1, key=run_key,
                y_workers=y_workers, o_list=o_list, step=step,
                dev_traces=dev_traces, comm=comm, prev_cost=prev_cost,
                active_mask=_active_mask(policy, num_workers),
                r_list=r_list, jitter_list=jitter_list, backend=engine_backend,
            )
        if stopping:
            break

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
        elif guard_divergence and step.trace is not None:
            # Track the layer cost so the guard's blow-up check has a
            # reference even without size estimation.
            prev_cost = float(step.trace.objective[-1])

        if layer < cfg.num_layers:
            w_next = ssfn_lib.build_weight(step.o_star, r_list[layer], q)
        layer += 1

    # One fetch of every per-layer trace after the loop.
    traces = [[_host(t) for t in tr] for tr in dev_traces]
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
        jitter_levels=(
            np.stack(jitter_list) if jitter_list else np.zeros((0, 0), np.int32)
        ),
        rollbacks=rollbacks,
    )
    return params, log


def _train_consensus_fn_path(
    x_workers: Tensor,
    t_workers: Tensor,
    cfg: ssfn_lib.SSFNConfig,
    generator: torch.Generator | None,
    *,
    r: Sequence[Tensor] | None,
    key,
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
    r_list = _random_matrices(cfg, generator, r, key, x_workers.device)

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
    key=None,
) -> tuple[ssfn_lib.SSFNParams, LayerwiseLog]:
    """Centralized SSFN = the same loop with all data on one worker (M=1)."""
    return train_decentralized_ssfn(x[None], t[None], cfg, generator, r=r, key=key)


def accuracy(params: ssfn_lib.SSFNParams, x: Tensor, labels: Tensor, q: int) -> float:
    pred = ssfn_lib.classify(params, x, q)
    return float((pred == labels.to(pred.device)).float().mean())
