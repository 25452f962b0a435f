"""Basic layers: init helpers, RMS and layer norms, embeddings.

Port of ``repro/nn/layers.py``.  The init helpers draw from a
``torch.Generator`` with the reference's distributions (not its numbers:
``jax.random`` and torch give different draws from one seed), on the
generator's device.  A model's parameter tree is laid out once over a
*draw* (:class:`GenDraw` or :class:`KeyDraw`); a :class:`KeyDraw` gives
the reference's own numbers from its threefry key.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import prng


def dense_init(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype, scale: float | None = None
) -> torch.Tensor:
    """N(0, 1) * scale, by default 1/sqrt(fan_in) with fan_in = shape[-2]
    (leading dimensions stack independent layers), drawn in f32 and cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * s).to(dtype)


def dense_init_by_slice(
    gen: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype
) -> torch.Tensor:
    """:func:`dense_init` of ``shape`` in ``dtype``, each matrix (the last
    two axes; one expert of one layer) drawn on its own, so that no f32
    temporary larger than one matrix is made."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    flat = out.view((-1,) + tuple(shape[-2:]))
    for i in range(flat.shape[0]):
        flat[i] = dense_init(gen, tuple(shape[-2:]), dtype)
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * 0.02, drawn in f32 and cast."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


class GenDraw:
    """The init helpers over one ``torch.Generator``: every leaf is drawn
    from its stream in call order (:meth:`split` hands out the same
    stream), with ``stack`` leading the shapes of stacked layers."""

    def __init__(self, gen: torch.Generator, stack: tuple[int, ...] = ()):
        self.gen, self.stack, self.device = gen, tuple(stack), gen.device

    def split(self, n: int) -> list[GenDraw]:
        return [self] * n

    def layers(self, n: int) -> GenDraw:
        return GenDraw(self.gen, self.stack + (n,))

    def dense(self, shape, dtype: torch.dtype, by_slice: bool = False) -> torch.Tensor:
        """:func:`dense_init`; ``by_slice`` one matrix at a time
        (:func:`dense_init_by_slice`)."""
        init = dense_init_by_slice if by_slice else dense_init
        return init(self.gen, self.stack + tuple(shape), dtype)

    def embed(self, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
        return embed_init(self.gen, vocab, d, dtype)

    def ones(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones(self.stack + tuple(shape), dtype=dtype, device=self.device)


class KeyDraw(GenDraw):
    """The init helpers over a threefry key tree (:mod:`repro_torch.prng`),
    as the reference's ``init(key)`` draws: :meth:`split` is its
    ``jax.random.split``, :meth:`layers` its ``vmap`` over one key a layer
    (the keys' batch shape leads the shapes), :meth:`dense`'s scale an f32
    quotient.  ``prng.normal`` gives jax's normals to 2 f32 ulps.  Each
    leaf is drawn whole in f32 on ``device`` (an MoE's experts too, so
    this is for configs whose f32 leaves fit) and cast."""

    def __init__(self, keys, device: torch.device):
        self.keys, self.device = prng.key_data(keys), device
        self.stack = self.keys.shape[:-1]

    def split(self, n: int) -> list[KeyDraw]:
        return [KeyDraw(k, self.device) for k in np.moveaxis(prng.split(self.keys, n), -2, 0)]

    def layers(self, n: int) -> KeyDraw:
        return KeyDraw(prng.split(self.keys, n), self.device)

    def dense(self, shape, dtype: torch.dtype, by_slice: bool = False) -> torch.Tensor:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = np.float32(1.0) / np.sqrt(np.float32(fan_in))
        return (prng.normal(self.keys, tuple(shape), device=self.device)
                * float(scale)).to(dtype)

    def embed(self, vocab: int, d: int, dtype: torch.dtype) -> torch.Tensor:
        return (prng.normal(self.keys, (vocab, d), device=self.device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The reference's cast order: normalise in f32, cast back to x's
    dtype, then scale by gamma in that dtype."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def rms_norm_split(x: torch.Tensor, gamma: torch.Tensor, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` over a last axis of ``width`` entries of which x
    holds this rank's block (``gamma`` its block too), split over the
    model row: the f32 sum of squares added over the row
    (``sharding/parallel.sum_over_model``) and divided by the whole
    width, in :func:`rms_norm`'s cast order.  With x whole it is
    :func:`rms_norm`."""
    if x.shape[-1] == width:
        return rms_norm(x, gamma, eps)
    from repro_torch.sharding.parallel import sum_over_model

    dt = x.dtype
    x32 = x.float()
    var = sum_over_model(torch.sum(x32 * x32, dim=-1, keepdim=True)) / width
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma


def layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """The reference's cast order: mean and (biased) variance in f32,
    normalise, cast back to x's dtype, then ``* gamma + beta`` in it."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * gamma + beta


def embed_lookup(
    embedding: torch.Tensor, ids: torch.Tensor, vocab_start: int | None = None
) -> torch.Tensor:
    """Rows of ``embedding`` (V, d) at integer ``ids`` (...) -> (..., d).
    With ``vocab_start``, ``embedding`` is the block of rows from
    ``vocab_start`` on (one rank's vocab shard): an id outside it looks up
    a zero row, so the shards' lookups add up to the whole one."""
    if vocab_start is None:
        return torch.nn.functional.embedding(ids, embedding)
    local = ids - vocab_start
    own = (local >= 0) & (local < embedding.shape[0])
    rows = torch.nn.functional.embedding(torch.where(own, local, 0), embedding)
    return rows * own[..., None].to(rows.dtype)


def vocab_parallel_embed_lookup(
    embedding: torch.Tensor, ids: torch.Tensor, vocab_start: int
) -> torch.Tensor:
    """The vocab-parallel lookup: this rank's masked lookup of its shard
    (``vocab_start`` on), added over the model row (``sharding/parallel.
    leave_model``; one shard holds each id, so the sum is exact)."""
    from repro_torch.sharding.parallel import leave_model

    return leave_model(embed_lookup(embedding, ids, vocab_start))


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple
