"""Loss and step functions: the scoring loss, the train step, prefill and
one greedy decode step.  Port of ``repro/models/steps.py``.

``make_train_step`` differentiates ``make_loss_fn``'s loss with
``torch.autograd.grad`` over the parameter leaves (grad mode on inside
it, whatever the caller's) and updates them under ``torch.no_grad()``;
the other steps record no graph when the caller runs them under
``torch.no_grad()``, as the serving launchers do.  A model with
``cfg.use_pallas_kernels`` cannot be trained: no kernel op has a
backward (``kernels/_autograd.py``), in the port as in ``repro``."""
from __future__ import annotations

import torch

from repro_torch import _tree

IGNORE = -1
MOE_AUX_COEF = 0.01


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in f32; labels == IGNORE are masked.  logits: (..., V)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0)[..., None].long())[..., 0]
    nll = lse - ll
    mask = (labels != IGNORE).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_loss_fn(model):
    """(params, batch) -> loss: the full-sequence forward scored against
    batch['labels'].  A VLM's visual prefix is not scored (its
    ``num_patches`` positions get IGNORE labels), and an MoE model adds
    ``MOE_AUX_COEF`` times the layers' mean router aux loss."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        labels = batch["labels"]
        if cfg.family == "vlm" and cfg.num_patches:
            pad = torch.full(labels.shape[:1] + (cfg.num_patches,), IGNORE,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        loss = cross_entropy(logits, labels)
        if cfg.num_experts:
            loss = loss + MOE_AUX_COEF * aux
        return loss

    return loss_fn


def make_grad_fn(model):
    """(params, batch) -> (loss, grads): ``make_loss_fn``'s loss (detached)
    and its gradient, a tree shaped like ``params``.  Every parameter leaf
    is made to require grad (in place), so the tensors the caller holds
    are the ones differentiated; a leaf the loss does not reach gets a zero
    gradient, as ``jax.grad`` gives it."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        flat = _tree.leaves(params)
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        return loss.detach(), _tree.unflatten(params, grads)

    return grad_fn


def global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, leaf sums added in
    ``jax.tree.leaves`` order (sorted keys), as ``repro``'s train step
    reduces them (per leaf, never one flattened vector)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _tree.leaves(grads)))


def make_train_step(model, optimizer):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}).  The optimizer writes the new params and moments into
    the tensors it is given (``optim/optimizers.py``) and the step returns
    them: leaves that require grad, ready for the next step."""
    grad_fn = make_grad_fn(model)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads)
            params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model):
    """One decode step: greedy-pick the next token (audio: one per
    codebook, (B, nc)) and update the cache."""

    def serve_step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, logits, cache

    return serve_step
