"""Loss and step functions for the inference slice: the scoring loss,
prefill and one greedy decode step.  Port of ``repro/models/steps.py``;
``make_train_step`` waits for model-zoo training (ROADMAP Queue 1 item 13).
Callers run these under ``torch.no_grad()``."""
from __future__ import annotations

import torch

IGNORE = -1


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
    batch['labels'].  The reference's VLM and MoE terms do not arise: only
    dense models are built."""

    def loss_fn(params, batch):
        logits, _ = model.forward(params, batch)
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model):
    """One decode step: greedy-pick the next token and update the cache."""

    def serve_step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache)
        next_token = torch.argmax(logits[:, -1], dim=-1)
        return next_token, logits, cache

    return serve_step
