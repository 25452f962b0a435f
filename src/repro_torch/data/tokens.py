"""Synthetic LM token pipeline for the big-architecture examples (a
numpy-only copy of ``repro/data/tokens.py``).

Deterministic, seedable stream of (tokens, labels) batches with a planted
n-gram structure so the LM loss meaningfully decreases during the e2e
example runs.  Batches are host-side numpy; the caller moves them to the
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class TokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    num_codebooks: int = 0   # audio models: token grid (B, S, nc)

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed)
        # Planted bigram table: next token depends on current (plus noise).
        table = rng.integers(0, self.vocab_size, size=(self.vocab_size,), dtype=np.int32)
        while True:
            if self.num_codebooks:
                shape = (self.batch_size, self.seq_len + 1, self.num_codebooks)
            else:
                shape = (self.batch_size, self.seq_len + 1)
            toks = np.empty(shape, np.int32)
            first = rng.integers(0, self.vocab_size, size=shape[:1] + shape[2:])
            toks[:, 0] = first
            for t in range(1, self.seq_len + 1):
                follow = table[toks[:, t - 1]]
                noise = rng.integers(0, self.vocab_size, size=follow.shape)
                use_noise = rng.random(follow.shape) < 0.15
                toks[:, t] = np.where(use_noise, noise, follow)
            yield {
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],   # audio: (B, S, nc) per-codebook labels
            }


def batches(stream: TokenStream, num: int):
    it = iter(stream)
    return [next(it) for _ in range(num)]
