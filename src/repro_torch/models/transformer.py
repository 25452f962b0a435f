"""Scan-over-layers decoder-only transformer covering the dense, MoE, SWA,
VLM-backbone and audio-decoder families.

Port of ``repro/models/transformer.py``.  Parameters are a dict of
tensors with the reference's names and layout: per-layer weights stacked
on a leading L axis (``params["layers"]``), so
``convert.transformer_params_from_numpy`` carries ``repro``'s params
across unchanged.  The layer scan becomes a Python loop.  ``forward`` is
the full-sequence pass that scores and trains a batch (through the
flash_attention op when ``cfg.use_pallas_kernels``, which only inference
may set: the op has no backward); ``prefill`` and ``decode_step`` take
the plain chunked and decode attention, as the reference routes them.
When autograd records, ``cfg.remat`` recomputes each layer in the
backward pass (``torch.utils.checkpoint`` for ``jax.checkpoint``), and
``cfg.remat_block`` = k (with L a multiple of k above it) keeps only
every k-th layer's input, recomputing each group of k layers with
per-layer remat inside, as the reference's two-level remat does.

The families differ only at the ends and in the FFN: an MoE model's FFN
is ``nn/moe.py``'s (its forward returns the layers' mean router aux
loss); a VLM prepends ``patch_embeds @ patch_proj`` (the stubbed vision
encoder's output, projected) to the token embeddings when the batch has
them; an audio model embeds a (B, S, nc) codebook grid as the sum of nc
lookups and its head gives (B, S, nc, V) logits.

On a (data, model) grid of ranks (``sharding/parallel.use_grid``) the
same methods run one rank's share, on its shard of the parameters
(``sharding/rules.shard_params_by_name``) and its data row's sequences:
the embedding vocab-parallel, attention over this rank's heads, the FFN
or MoE over its f-slice, and logits split over the model row as the
reference's are (``_head``); ``models/steps.py`` scores them.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.nn import attention as attn_lib
from repro_torch.nn.layers import (GenDraw, KeyDraw, embed_lookup, rms_norm,
                                   vocab_parallel_embed_lookup)
from repro_torch.sharding import parallel as par

Params = dict[str, Any]


def layer_views(layers: Params, n: int) -> list[Params]:
    """All ``n`` layers' parameters as views of the stacked leaves, by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would give each layer's backward a
    zero tensor of the whole stacked leaf to add into."""
    per_leaf = {k: layer_views(v, n) if isinstance(v, dict) else torch.unbind(v)
                for k, v in layers.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def remat(fn, cfg: ModelConfig):
    """``fn`` whose activations are recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat`` and
    autograd is recording; ``fn`` itself otherwise.  On a grid the
    recompute runs under the grid current at the call: the backward of
    card tensors runs on autograd's device thread, which has none."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    grid = par.current_grid()
    if grid is not None:
        inner = fn

        def fn(*args):
            with par.use_grid(grid):
                return inner(*args)

    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False)


def _vocab_start(emb: torch.Tensor, cfg: ModelConfig) -> int | None:
    """The first vocab id of this rank's ``embed`` rows (V or V / model of
    them), or None where the vocabulary is whole."""
    vl = emb.shape[-2]
    return (par.current_grid().model_index * vl
            if par.model_split(vl, cfg.padded_vocab) else None)


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The token embeddings (B, S, d) of a text model's ``tokens``.  On a
    grid ``embed`` is this rank's vocab shard, its FSDP rows gathered: a
    masked local lookup, added over the model row (every family's
    vocab-parallel embedding)."""
    emb = par.fsdp(params["embed"], "embed", cfg.d_model)
    start = _vocab_start(emb, cfg)
    return (embed_lookup(emb, tokens) if start is None
            else vocab_parallel_embed_lookup(emb, tokens, start))


def head_logits(params: Params, x: torch.Tensor, cfg: ModelConfig,
                full: int | None = None) -> torch.Tensor:
    """``rms_norm(x, ln_f) @ head``: the logits over ``full`` columns
    (default the padded vocabulary).  On a grid ``head`` is this rank's
    block of columns, its FSDP rows gathered, and the logits come out
    split over the model row as its columns are (the normed input enters
    the column-parallel product through ``enter_model``)."""
    head = par.fsdp(params["head"], "head", cfg.d_model)
    xn = rms_norm(x, params["ln_f"])
    if par.model_split(head.shape[-1], full or cfg.padded_vocab):
        xn = par.enter_model(xn)
    return xn @ head


class TransformerModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator | None = None, *, key=None,
             device: str | torch.device | None = None) -> Params:
        """Seeded random parameters: drawn from ``gen`` on the generator's
        device, or from a threefry ``key`` (:mod:`repro_torch.prng`) on
        ``device`` (``None`` meaning ``cuda``), which gives ``repro``'s
        ``init(key)`` weights to a few f32 ulps.  One layout over either
        draw (:class:`~repro_torch.nn.layers.GenDraw`, ``KeyDraw``)."""
        if (gen is None) == (key is None):
            raise ValueError("pass exactly one of gen or key=")
        draw = GenDraw(gen) if key is None else KeyDraw(key, resolve_device(device))
        cfg = self.cfg
        v, d, dt = cfg.padded_vocab, cfg.d_model, cfg.torch_dtype
        # The reference's key tree; a generator draws in this code's order.
        k_embed, k_layers, k_head, k_extra = draw.split(4)
        params: Params = {
            "layers": blocks.init_transformer_layer(k_layers.layers(cfg.num_layers), cfg),
            "ln_f": draw.ones((d,), dt),
        }
        if cfg.family == "audio":
            nc = cfg.num_codebooks
            params["embed"] = torch.stack([k.embed(v, d, dt) for k in k_embed.split(nc)])
            params["head"] = k_head.dense((d, nc * v), dt)
        else:
            params["embed"] = k_embed.embed(v, d, dt)
            params["head"] = k_head.dense((d, v), dt)
        if cfg.family == "vlm":
            params["patch_proj"] = k_extra.dense((cfg.patch_dim, d), dt)
        return params

    # -------------------------------------------------------------- embed
    def _embed(self, params: Params, batch: dict) -> torch.Tensor:
        """The token embeddings (and a VLM's projected patches in front).
        On a grid ``embed`` is this rank's vocab shard: a masked local
        lookup, added over the model row."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "audio":
            emb = par.fsdp(params["embed"], "embed", cfg.d_model)
            start = _vocab_start(emb, cfg)
            # tokens (B, S, nc): the codebooks' embeddings summed in order
            # from 0, in the model's dtype, as the reference's sum().
            parts = [embed_lookup(emb[c], tokens[..., c], start)
                     for c in range(cfg.num_codebooks)]
            if start is not None:   # one all-reduce for the nc lookups
                parts = par.leave_model(torch.stack(parts)).unbind(0)
            x = sum(parts)
        else:
            x = embed_tokens(params, tokens, cfg)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            proj = par.fsdp(params["patch_proj"], "patch_proj", cfg.patch_dim)
            patches = batch["patch_embeds"].to(x.dtype) @ proj
            x = torch.cat([patches, x], dim=1)
        return x

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, V) (audio: (B, S, nc, V)).  On a grid they come
        out split over the model row as ``head``'s columns are, as in the
        reference (``shard(logits, ..., "tensor")``): (B, S, V / model)
        from vocab id ``model_index * V / model``; an audio model's nc * V
        columns split by codebook, (B, S, nc / model, V) from codebook
        ``model_index * nc / model``."""
        cfg = self.cfg
        full = cfg.padded_vocab * (cfg.num_codebooks if cfg.family == "audio" else 1)
        logits = head_logits(params, x, cfg, full)
        if cfg.family == "audio":
            b, s, cols = logits.shape
            if cols % cfg.padded_vocab:
                raise ValueError(f"{cfg.name}: a model row of "
                                 f"{par.current_grid().model_parallel} splits a codebook's "
                                 f"vocab; it must divide the {cfg.num_codebooks} codebooks")
            return logits.reshape(b, s, cols // cfg.padded_vocab, cfg.padded_vocab)
        return logits

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits, moe_aux)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)

        def body(x, layer_p):
            x, _, aux = blocks.apply_transformer_layer(layer_p, x, positions, cfg, None)
            return x, aux

        def group_body(x, group):
            auxs = []
            for layer_p in group:
                x, aux = step(x, layer_p)
                auxs.append(aux)
            return x, torch.stack(auxs)

        layers = layer_views(params["layers"], cfg.num_layers)
        step = remat(body, cfg)
        blk, n = cfg.remat_block, cfg.num_layers
        # Block remat: only the groups' inputs survive the forward pass;
        # each group of blk layers re-runs in its backward, remat inside.
        size = blk if blk and n % blk == 0 and n > blk else 1
        run_group = remat(group_body, cfg) if size > 1 else group_body
        auxs = []
        for g in range(0, n, size):
            x, aux = run_group(x, layers[g:g + size])
            auxs.append(aux)
        return self._head(params, x), torch.cat(auxs).mean()

    # ------------------------------------------------------------ prefill
    def prefill(self, params: Params, batch: dict, max_len: int | None = None):
        """Forward + collect the rotated KV into a decode cache sized for
        ``max_len`` total positions (defaults to the prompt length).
        Returns (logits of the last position, cache)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        window = cfg.window if cfg.attention == "swa" else None
        ks, vs = [], []
        for layer_p in layer_views(params["layers"], cfg.num_layers):
            h, (k, v) = _attention_collect_kv(layer_p, x, positions, cfg, window)
            x = x + h
            f, _ = blocks.apply_ffn(layer_p["ffn"], rms_norm(x, layer_p["ln2"]), cfg)
            if cfg.d_ff or cfg.num_experts:
                x = x + f
            ks.append(k)
            vs.append(v)
        cache = _kv_to_cache((torch.stack(ks), torch.stack(vs)), s, cfg, max_len=max_len)
        return self._head(params, x[:, -1:, :]), cache

    def init_cache(self, batch_size: int, max_len: int, device=None) -> attn_lib.KVCache:
        """An empty stacked cache: k, v (L, B, slots, KVH, hd), index (L,);
        on a grid KVH is this rank's KV heads and B its data row's."""
        cfg = self.cfg
        slots = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
        dev = resolve_device(device)
        shape = (cfg.num_layers, batch_size, slots, blocks.local_heads(cfg)[1], cfg.hd)
        return attn_lib.KVCache(
            k=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            v=torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            index=torch.zeros((cfg.num_layers,), dtype=torch.int32, device=dev),
        )

    def decode_step(self, params: Params, batch: dict, cache: attn_lib.KVCache):
        """One-token step.  batch['tokens']: (B, 1) (audio: (B, 1, nc));
        the position comes from the cache index.  Writes the token's KV
        into ``cache`` in place and returns (logits, cache with index + 1)."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = cache.index[:1]  # (1,), the same for all layers
        for i, layer_p in enumerate(layer_views(params["layers"], cfg.num_layers)):
            layer_cache = attn_lib.KVCache(k=cache.k[i], v=cache.v[i], index=cache.index[i])
            x, _, _ = blocks.apply_transformer_layer(layer_p, x, positions, cfg, layer_cache)
        # Every layer's index advanced by one token.
        new_cache = attn_lib.KVCache(k=cache.k, v=cache.v, index=cache.index + 1)
        return self._head(params, x), new_cache


def _attention_collect_kv(layer_p, x, positions, cfg, window):
    """Attention that also returns the rotated (k, v) for cache building.
    Always the plain chunked attention, as the reference's prefill; on a
    grid over this rank's heads."""
    s = x.shape[1]
    xn = rms_norm(x, layer_p["ln1"])
    q, k, v, wo, split = blocks.attention_qkv(layer_p["attn"], xn, positions, cfg)
    heads = q.shape[2]
    out = attn_lib.chunked_causal_attention(
        q,
        attn_lib.repeat_kv(k, heads),
        attn_lib.repeat_kv(v, heads),
        chunk_size=min(cfg.attn_chunk, s),
        window=window,
    )
    return blocks.attention_out(out, wo, split), (k, v)


def _kv_to_cache(kv_stack, seq_len: int, cfg: ModelConfig, max_len: int | None = None):
    """(L, B, S, KVH, hd) k/v -> decode cache with room for ``max_len``
    total positions.  When the prompt is longer than a sliding window's
    slots, the last ``slots`` tokens are kept, each at slot pos % slots:
    the ring layout ``cache_update`` continues."""
    k, v = kv_stack
    total = max(max_len or seq_len, seq_len)
    slots = min(total, cfg.window) if cfg.attention == "swa" else total
    if slots < seq_len:
        pos = torch.arange(seq_len - slots, seq_len, device=k.device)
        slot_idx = torch.remainder(pos, slots)
        last, lastv = k[:, :, seq_len - slots:], v[:, :, seq_len - slots:]
        k = torch.zeros_like(last).index_copy_(2, slot_idx, last)
        v = torch.zeros_like(lastv).index_copy_(2, slot_idx, lastv)
    elif slots > seq_len:
        pad = (0, 0, 0, 0, 0, slots - seq_len)   # dim 2 of (L, B, S, KVH, hd)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    index = torch.full((k.shape[0],), seq_len, dtype=torch.int32, device=k.device)
    return attn_lib.KVCache(k=k, v=v, index=index)
