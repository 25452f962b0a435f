"""Loss and step functions: the scoring loss, the train step, prefill and
one greedy decode step.  Port of ``repro/models/steps.py``.

``make_train_step`` differentiates ``make_loss_fn``'s loss with
``torch.autograd.grad`` over the parameter leaves (grad mode on inside
it, whatever the caller's) and updates them under ``torch.no_grad()``;
the other steps record no graph when the caller runs them under
``torch.no_grad()``, as the serving launchers do.  A model with
``cfg.use_pallas_kernels`` cannot be trained: no kernel op has a
backward (``kernels/_autograd.py``), in the port as in ``repro``.

On a (data, model) grid of ranks (``sharding/parallel.use_grid``) each
rank runs its share on its parameter shard: the loss a data row returns
is its part of the global loss (its tokens' NLL over the global token
count, and for an MoE its share of the aux loss), so the gradient of the
global loss is the sum over the data rows of theirs.  ``make_grad_fn``
adds up over the data column the gradient of every leaf the spec does not
split over the data axes (an FSDP leaf's was reduce-scattered by its
all-gather's backward) and returns the global loss; ``global_norm``
counts each element of the sharded gradient once; the logits come split
over the model row and ``cross_entropy_sharded`` and ``next_tokens``
score and pick across the shards."""
from __future__ import annotations

import functools

import torch

from repro_torch import _tree
from repro_torch.sharding import parallel as par
from repro_torch.sharding import rules as rules_lib

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


def cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor, cfg) -> torch.Tensor:
    """This data row's part of ``cross_entropy`` on a grid: the NLL summed
    over its tokens over the f32 sum of every row's token count.
    ``logits`` are this rank's shard (``TransformerModel._head``): split
    over the vocabulary (the max and the sum of exponentials all-reduced
    over the model row, the label's logit from the rank that holds it;
    the gradient of each reaches only its own columns), split by codebook
    (each rank's codebooks scored whole, their sums added over the row),
    or whole."""
    grid = par.current_grid()
    logits = logits.float()
    mask = (labels != IGNORE).float()
    audio = cfg.family == "audio"
    if audio and logits.shape[-2] != cfg.num_codebooks:
        ncl = logits.shape[-2]
        c0 = grid.model_index * ncl
        lab = labels[..., c0:c0 + ncl]
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab.clamp_min(0)[..., None].long())[..., 0]
        total = par.leave_model(torch.sum((lse - ll) * mask[..., c0:c0 + ncl]))
    elif logits.shape[-1] != cfg.padded_vocab:
        vl = logits.shape[-1]
        top = par.sum_f32(grid.model, logits.detach().amax(dim=-1), "max")
        sumexp = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
        lab = labels.clamp_min(0).long() - grid.model_index * vl
        own = (lab >= 0) & (lab < vl)
        ll = torch.gather(logits, -1, torch.where(own, lab, 0)[..., None])[..., 0] * own
        sumexp, ll = par.leave_model(torch.stack([sumexp, ll])).unbind(0)
        total = torch.sum((top + torch.log(sumexp) - ll) * mask)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.clamp_min(0)[..., None].long())[..., 0]
        total = torch.sum((lse - ll) * mask)
    count = par.sum_f32(grid.data, torch.sum(mask))
    return total / torch.clamp(count, min=1.0)


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
        grid = par.current_grid()
        if grid is None:
            loss = cross_entropy(logits, labels)
            if cfg.num_experts:
                loss = loss + MOE_AUX_COEF * aux
            return loss
        loss = cross_entropy_sharded(logits, labels, cfg)
        if cfg.num_experts:   # aux is the data rows' mean: each adds its share
            loss = loss + MOE_AUX_COEF * aux / grid.data_parallel
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
        grid = par.current_grid()
        if grid is None:
            return loss.detach(), _tree.unflatten(params, grads)
        data_axes = grid.rules.data_axes
        split = [rules_lib.is_split(s, data_axes) for s in leaf_specs(model.cfg, grid)]
        grads = [g if f else par.sum_f32(grid.data, g) for g, f in zip(grads, split, strict=True)]
        return par.sum_f32(grid.data, loss.detach()), _tree.unflatten(params, grads)

    return grad_fn


@functools.lru_cache(maxsize=16)
def _leaf_specs(cfg, rules, plan) -> tuple:
    from repro_torch.launch.specs import leaves_with_path, lookup

    specs = rules_lib.param_specs(cfg, rules, plan)
    return tuple(lookup(specs, path) for path, _ in leaves_with_path(
        rules_lib.param_shapes_meta(cfg)))


def leaf_specs(cfg, grid) -> tuple:
    """The spec of every parameter leaf of ``cfg``'s model (any family)
    on ``grid``, in ``jax.tree.leaves`` order."""
    return _leaf_specs(cfg, grid.rules, grid.plan)


def global_norm(grads, cfg=None) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, leaf sums added in
    ``jax.tree.leaves`` order (sorted keys), as ``repro``'s train step
    reduces them (per leaf, never one flattened vector).  On a grid
    (``cfg`` given) the gradient is sharded: each rank sums the squares
    of its leaves that no rank before it along an axis holds a copy of
    (a leaf the spec does not split over the model axis counts at model
    index 0 only, one it does not split over the data axes at data index
    0 only), the per-leaf sums are added over the grid in one f32
    all-reduce, then over the leaves in order."""
    grid = par.current_grid()
    sums = [torch.sum(torch.square(g.float())) for g in _tree.leaves(grads)]
    if grid is None or cfg is None:
        return torch.sqrt(sum(sums))
    model_axes, data_axes = (grid.rules.model_axis,), grid.rules.data_axes
    own = [(rules_lib.is_split(s, model_axes) or grid.model_index == 0)
           and (rules_lib.is_split(s, data_axes) or grid.data_index == 0)
           for s in leaf_specs(cfg, grid)]
    mine = torch.stack([x if o else torch.zeros_like(x) for x, o in zip(sums, own, strict=True)])
    return torch.sqrt(sum(par.sum_f32(grid.world, mine).unbind(0)))


def make_train_step(model, optimizer):
    """(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}).  The optimizer writes the new params and moments into
    the tensors it is given (``optim/optimizers.py``) and the step returns
    them: leaves that require grad, ready for the next step."""
    grad_fn = make_grad_fn(model)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        with torch.no_grad():
            gnorm = global_norm(grads, model.cfg)
            params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def next_tokens(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The greedy pick from one position's logits (B, V) (audio: (B, nc,
    V), one token a codebook): ``argmax``, ties to the lower index.  On a
    grid the logits are this rank's shard: across vocab shards the pick
    is ``parallel.vocab_argmax``'s; an audio model's codebook shards are
    picked whole and gathered over the model row."""
    grid = par.current_grid()
    if grid is None:
        return torch.argmax(logits, dim=-1)
    if cfg.family == "audio":
        return par.all_gather_dim(grid.model, torch.argmax(logits, dim=-1), 1)
    return par.vocab_argmax(logits)


def make_serve_step(model):
    """One decode step: greedy-pick the next token (audio: one per
    codebook, (B, nc)) and update the cache."""

    def serve_step(params, batch, cache):
        logits, cache = model.decode_step(params, batch, cache)
        next_token = next_tokens(logits[:, -1], model.cfg)
        return next_token, logits, cache

    return serve_step
