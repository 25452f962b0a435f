"""The inputs of one train, drawn on the device from the run's seed.

A planted-teacher classification problem with a configuration's
(P, Q, J): x ~ N(0, 1); a tanh teacher of ``teacher.layers`` layers of
N(0, 1)/sqrt(fan_in) weights and ``teacher.width`` units, plus
``teacher.label_noise`` Gaussian logit noise, labels it; x is
standardized with the training split's mean and population standard
deviation.  The training split is cut into M equal worker shards in
sample order (the paper's uniform division).  The random matrices
R_1..R_L of the net are N(0, 1)/sqrt(fan_in).

Every train of a run gets its own draw: train ``index`` of seed ``seed``
draws from a generator seeded with a hash of both, so the same seed gives
the same inputs, and the reference can draw a sampled train's inputs
again after the window.  The teacher runs in float64, so its labels do
not depend on a matmul precision setting.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Inputs(NamedTuple):
    x_workers: Tensor   # (M, P, J_m) column-stacked inputs per worker
    t_workers: Tensor   # (M, Q, J_m) one-hot targets per worker
    x_test: Tensor      # (P, J_test)
    r: tuple            # R_1 ((n-2Q), P), R_2..R_L ((n-2Q), n)


def generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for train ``index`` of run ``seed``."""
    digest = hashlib.sha256(f"portbench:{int(seed)}:{int(index)}".encode()).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def make(cfg: dict, seed: int, index: int, device) -> Inputs:
    """Train ``index``'s data and random matrices for configuration ``cfg``
    (a ``configs/*.json`` object), in float32 on ``device``."""
    gen = generator(seed, index, device)
    p, q = cfg["input_dim"], cfg["num_classes"]
    m, n, layers = cfg["workers"], cfg["hidden"], cfg["num_layers"]
    num_train, num_test = cfg["num_train"], cfg["num_test"]
    if num_train % m:
        raise ValueError(f"{num_train} training samples do not divide over {m} workers")
    teacher = cfg["teacher"]
    j = num_train + num_test
    f32, f64 = torch.float32, torch.float64

    def normal(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    x = normal(p, j)
    h, dim = x.to(f64), p
    for _ in range(teacher["layers"]):
        h = torch.tanh(normal(teacher["width"], dim, dtype=f64) / math.sqrt(dim) @ h)
        dim = teacher["width"]
    w_out = normal(q, dim, dtype=f64) / math.sqrt(dim)
    logits = w_out @ h + teacher["label_noise"] * normal(q, j, dtype=f64)
    labels = torch.argmax(logits, dim=0)
    t = torch.zeros((q, j), dtype=f32, device=device)
    t.scatter_(0, labels[None], 1.0)
    train = x[:, :num_train]
    mean = train.mean(dim=1, keepdim=True)
    sd = train.std(dim=1, keepdim=True, correction=0) + 1e-6
    x = (x - mean) / sd
    jm = num_train // m
    x_workers = x[:, :num_train].reshape(p, m, jm).permute(1, 0, 2).contiguous()
    t_workers = t[:, :num_train].reshape(q, m, jm).permute(1, 0, 2).contiguous()
    x_test = x[:, num_train:].contiguous()

    # R_1..R_L from one draw, cut into per-layer views.
    rows = n - 2 * q
    fan_ins = [p] + [n] * (layers - 1)
    flat = normal(rows * sum(fan_ins))
    r, at = [], 0
    for fan_in in fan_ins:
        r.append(flat[at: at + rows * fan_in].view(rows, fan_in) / math.sqrt(fan_in))
        at += rows * fan_in
    return Inputs(x_workers, t_workers, x_test, tuple(r))
