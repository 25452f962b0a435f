"""The dSSFN layer engine: one layer step as one backend program.

Port of ``repro/core/engine.py``.  :func:`fused_layer_step` runs the
whole per-layer pipeline for all M workers:

    Y_l = relu(W_l @ Y_{l-1}),  G = Y_l Y_l^T + I/mu   (propagate_gram; l >= 1)
    G   = Y_0 Y_0^T + I/mu                            (gram; l = 0, no W)
    L   = guarded chol(G),  A = T Y_l^T
    K x eq.-11 ADMM iterations                        (consensus per iteration)

Propagation and the Gram product are one op, ``propagate_gram``, called
once for all M workers with W shared; on the card it launches the
hand-written CUDA kernels (``kernels/csrc/propagate_gram.cu``) at every
shape, where the reference takes its Pallas kernel only on 128-aligned
shapes.  There is no ``donate_y``: the previous layer's Y is freed once
nothing refers to it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import admm as admm_lib
from repro_torch.core.backend import ConsensusBackend
from repro_torch.core.policy import ConsensusPolicy
from repro_torch.kernels.propagate_gram import propagate_gram

Tensor = torch.Tensor


class LayerStepResult(NamedTuple):
    o_star: Tensor     # (Q, n) consensus readout Z^K for this layer
    o_workers: Tensor  # (M, Q, n) per-worker primal variables
    lam: Tensor        # (M, Q, n) scaled duals
    y_workers: Tensor  # (M, n, J_m) this layer's features (post-propagation)
    #: (K/trace_every,) worker-0 traces on the device; None when
    #: trace_every=0.
    trace: "admm_lib.ADMMTrace | None"
    #: (M,) per-worker guarded-Cholesky jitter level (int32; 0 = the
    #: Gram factored clean; see ``admm.guarded_cholesky``).
    jitter: "Tensor | None" = None


def _propagate_and_stats(w: Tensor, y_workers: Tensor, t_workers: Tensor, mu: float):
    """relu(W @ Y_m) and G_m in one op for all workers, then (A_m,
    chol(G_m), jitter) as the reference's kernel path builds them,
    including the cast of G to Y's dtype."""
    y_new, g = propagate_gram(w, y_workers.contiguous(), mu=mu)
    y_new = y_new.to(y_workers.dtype)
    chol, jitter = admm_lib.guarded_cholesky(g.to(y_workers.dtype))
    a = torch.matmul(t_workers, y_new.mT)
    return y_new, a, chol, jitter


def fused_layer_step(
    backend: ConsensusBackend,
    y_workers: Tensor,
    t_workers: Tensor,
    w: Tensor | None,
    *,
    mu: float,
    eps_radius: float,
    num_iters: int,
    policy: ConsensusPolicy | None = None,
    trace_every: int = 1,
) -> LayerStepResult:
    """One dSSFN layer step for all M workers as one backend program.

    y_workers: (M, n_{l-1}, J_m) previous-layer features (the layer input
        x at l=0), stacked per worker; under a ``MeshBackend`` the rank's
        (M/W, ...) block, over which the rank's ``propagate_gram`` runs.
        ``o_star`` and ``jitter`` come back gathered from every worker,
        ``o_workers``, ``lam`` and ``y_workers`` as the held block.
    w: the layer weight W_l = [V_Q O_{l-1} ; R_l] shared by every worker,
        or None at l=0 (solve directly on the input features).
    policy: consensus strategy for the ADMM iterations (default: the
        backend's policy); part of the program's identity.
    trace_every: convergence-trace stride (``admm.worker_admm_iterations``).
    """
    m = y_workers.shape[0]
    if m != backend.local_workers:
        raise ValueError(
            f"y_workers has {m} worker shards, backend expects {backend.local_workers}"
        )
    policy = policy if policy is not None else backend.policy
    policy.validate(backend.num_workers)
    trace_every = admm_lib.validate_trace_every(trace_every, num_iters)
    # Interval-mixing policies run whole local/communicate chunks;
    # surface the incompatible configurations here, with the reference's
    # messages.
    interval = policy.communication_interval
    if interval > 1:
        if num_iters % interval:
            raise ValueError(
                f"communication_interval={interval} must divide "
                f"num_iters={num_iters} (whole local/communicate chunks)"
            )
        if trace_every > 1:
            raise ValueError(
                "communication_interval > 1 supports trace_every in {0, 1} "
                f"only, got {trace_every}"
            )

    def worker(y_m: Tensor, t_m: Tensor, *w_rep: Tensor):
        if w_rep:
            y_m, a, chol, jitter = _propagate_and_stats(w_rep[0], y_m, t_m, mu)
        else:
            a, chol, jitter = admm_lib._worker_stats(y_m, t_m, mu)
        z_init = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
        (o, z, lam), traces = admm_lib.worker_admm_iterations(
            backend, a, chol, y_m, t_m, z_init,
            mu=mu, eps_radius=eps_radius, num_iters=num_iters, policy=policy,
            trace_every=trace_every,
        )
        return (o, z, lam, y_m), traces, jitter

    key = (
        "dssfn_layer", float(mu), float(eps_radius), int(num_iters),
        w is not None, trace_every,
    )
    (o_w, z_w, lam_w, y_next), traces, jitter_w = backend.run(
        worker, y_workers, t_workers,
        replicated=() if w is None else (w,), key=key, policy=policy,
    )
    return LayerStepResult(
        o_star=backend.gather_workers(z_w)[0], o_workers=o_w, lam=lam_w,
        y_workers=y_next,
        trace=None if traces is None else admm_lib.ADMMTrace(*traces),
        jitter=backend.gather_workers(jitter_w),
    )
