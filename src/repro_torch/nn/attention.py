"""GQA attention: chunked online-softmax causal attention (full-sequence
forward and prefill) and single-token decode against a KV cache, which is
a ring buffer for sliding-window archs.

Port of ``repro/nn/attention.py``.  The chunked path is the plain analogue
of the ``flash_attention`` kernel: an online softmax over KV chunks, with
O(S * chunk) score memory instead of O(S^2).  Masked scores are
``NEG_INF = -1e30`` (not ``-inf``) and denominators are clamped at 1e-30,
as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -1e30


def _scale(hd: int) -> float:
    """1/sqrt(hd) rounded as the reference computes it, in f32.  A Python
    float and not a device tensor: a tensor made from a host value costs a
    copy that waits for the card's queue, in every layer."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def repeat_kv(kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KVH, hd) -> (B, S, H, hd): query head h reads KV head
    h // (H / KVH), each KV head repeated in place (``jnp.repeat``, i.e.
    ``repeat_interleave``, not ``Tensor.repeat``, which would tile)."""
    kvh = kv.shape[2]
    if kvh == num_heads:
        return kv
    return torch.repeat_interleave(kv, num_heads // kvh, dim=2)


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    chunk_size: int = 1024,
    window: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Causal (optionally sliding-window) attention via online softmax.

    q: (B, Sq, H, hd); k, v: (B, Sk, H, hd), KV already repeated to H.
    q_offset: absolute position of q[0] relative to k[0] (prefill: 0).
    window: attend to keys with 0 <= pq - pk < window.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qf = q.float() * _scale(hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    for start in range(0, sk, chunk_size):
        kj = k[:, start:start + chunk_size].float()
        vj = v[:, start:start + chunk_size].float()
        k_pos = start + torch.arange(kj.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)   # (B, Sq, H, hd)


class KVCache(NamedTuple):
    """Decode-time KV cache.

    k, v: (B, S_slots, KVH, hd), where S_slots = min(seq_len, window) for
    sliding-window archs (ring buffer) or seq_len for full attention.
    index: () int32, the number of tokens written so far (the absolute
    position of the next one).  A model's cache stacks the layers on a
    leading axis: k, v (L, B, S_slots, KVH, hd) and index (L,).
    """
    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor

    @property
    def slots(self) -> int:
        return self.k.shape[-3]


def init_kv_cache(
    batch: int, slots: int, kv_heads: int, head_dim: int, dtype: torch.dtype, device=None
) -> KVCache:
    shape = (batch, slots, kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        index=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Write one token (B, 1, KVH, hd) at slot index % slots (a ring for
    SWA).  Unlike the reference this writes into ``cache.k``/``cache.v``
    in place (the returned cache shares them), so a step copies one token
    and not the whole cache; the slot stays a device tensor, with no host
    sync."""
    slot = torch.remainder(cache.index, cache.slots).reshape(1).long()
    cache.k.index_copy_(1, slot, k_new)
    cache.v.index_copy_(1, slot, v_new)
    return KVCache(k=cache.k, v=cache.v, index=cache.index + 1)


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    *,
    num_heads: int,
    window: int | None = None,
) -> torch.Tensor:
    """One-token attention: q (B, 1, H, hd) against the cache.

    Keys are stored after RoPE, so the softmax does not depend on slot
    order and the ring needs no unrotation; the mask keeps only written
    (and in-window) slots.  cache.index counts the current token.
    """
    hd = q.shape[-1]
    k = repeat_kv(cache.k, num_heads).float()
    v = repeat_kv(cache.v, num_heads).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * _scale(hd), k)
    slots = cache.slots
    slot_ids = torch.arange(slots, device=q.device)
    written = slot_ids < torch.clamp(cache.index, max=slots)
    if window is not None:
        # The slot holds the largest position p < index with p % slots == slot.
        last = cache.index - 1
        abs_pos = last - torch.remainder(torch.remainder(last, slots) - slot_ids, slots)
        written &= (last - abs_pos) < window
    s = torch.where(written[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out.to(q.dtype)
