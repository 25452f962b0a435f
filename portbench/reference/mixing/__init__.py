"""The reference's consensus mixes, one rule a file, found by name.

A traffic file (``traffic/<name>.json``) names its rule under
``"mixing"``: ``{"rule": "<file name>", ...parameters}``.  Each rule's
module defines ``make(m, *, device, dtype, **parameters)``, which returns
``mix(sent, layer, iteration)``: the (M, Q, d) blocks the workers send in
one ADMM iteration of one layer, mixed.  A new consensus is a new file
here, written from its definition, never from the program.
"""
from __future__ import annotations

import importlib

import torch


def make(spec: dict, m: int, *, device, dtype):
    """The mix of the rule that ``spec`` names, over ``m`` workers."""
    params = dict(spec)
    rule = importlib.import_module(f"{__name__}.{params.pop('rule')}")
    return rule.make(m, device=device, dtype=dtype, **params)


def by_matrix(h: torch.Tensor):
    """The mix sum_j H[m, j] x_j of a fixed M x M matrix, as a weighted
    sum, never a product: TF32 does not touch it, as it does not touch
    the program's hops."""
    def mix(sent, layer, iteration):
        return sum(h[:, j, None, None] * sent[j] for j in range(h.shape[0]))
    return mix
