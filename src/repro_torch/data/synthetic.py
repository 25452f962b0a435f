"""Synthetic datasets with the exact tensor geometry of the paper's Table I.

Port of ``repro/data/synthetic.py``.  The UCI/MNIST/NORB datasets are
replaced by planted-teacher classification problems with identical
(P, Q, J) shapes.  Numerical equivalence claims (dSSFN == centralized
SSFN) are data-independent; absolute accuracies are for the synthetic
tasks only.

The draws come from a ``torch.Generator`` on its own device, so the data
can be made where it is used.  They are PyTorch's, not ``jax.random``'s:
to hold the two packages against each other, carry ``repro``'s dataset
across (``convert.dataset_from_numpy``).  The partitions are pure index
arithmetic and equal ``repro``'s on the same arrays.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# (name, train, test, P, Q) — paper Table I.
PAPER_DATASETS = {
    "vowel": (528, 462, 10, 11),
    "satimage": (4435, 2000, 36, 6),
    "caltech101": (6000, 3000, 3000, 102),
    "letter": (13333, 6667, 16, 26),
    "norb": (24300, 24300, 2048, 5),
    "mnist": (60000, 10000, 784, 10),
}


class Dataset(NamedTuple):
    x_train: Tensor   # (P, J) column-stacked, standardized
    t_train: Tensor   # (Q, J) one-hot
    y_train: Tensor   # (J,) labels
    x_test: Tensor
    t_test: Tensor
    y_test: Tensor

    @property
    def input_dim(self) -> int:
        return self.x_train.shape[0]

    @property
    def num_classes(self) -> int:
        return self.t_train.shape[0]


def make_classification(
    generator: torch.Generator,
    *,
    num_train: int,
    num_test: int,
    input_dim: int,
    num_classes: int,
    teacher_layers: int = 2,
    teacher_width: int = 64,
    label_noise: float = 0.05,
) -> Dataset:
    """Planted nonlinear-teacher classification problem, made on the
    generator's device: x ~ N(0, 1); a tanh teacher of ``teacher_layers``
    layers of N(0, 1)/sqrt(fan_in) weights plus ``label_noise`` Gaussian
    logit noise labels it; x is standardized with the training split's
    mean and (population) standard deviation."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    j = num_train + num_test
    x = normal(input_dim, j)
    h = x
    dim = input_dim
    for _ in range(teacher_layers):
        h = torch.tanh((normal(teacher_width, dim) / math.sqrt(dim)) @ h)
        dim = teacher_width
    w_out = normal(num_classes, dim) / math.sqrt(dim)
    logits = w_out @ h + label_noise * normal(num_classes, j)
    labels = torch.argmax(logits, dim=0)
    t = torch.nn.functional.one_hot(labels, num_classes).T.to(torch.float32)
    # Standardize features (as the paper's Matlab pipeline does).
    mu = x[:, :num_train].mean(dim=1, keepdim=True)
    sd = x[:, :num_train].std(dim=1, keepdim=True, correction=0) + 1e-6
    x = (x - mu) / sd
    return Dataset(
        x_train=x[:, :num_train],
        t_train=t[:, :num_train],
        y_train=labels[:num_train],
        x_test=x[:, num_train:],
        t_test=t[:, num_train:],
        y_test=labels[num_train:],
    )


def paper_dataset(name: str, generator: torch.Generator, *, scale: float = 1.0) -> Dataset:
    """Synthetic stand-in with the paper's Table I geometry (optionally
    scaled down for quick runs)."""
    ntr, nte, p, q = PAPER_DATASETS[name]
    return make_classification(
        generator,
        num_train=max(q * 4, int(ntr * scale)),
        num_test=max(q * 4, int(nte * scale)),
        input_dim=p,
        num_classes=q,
    )


def partition_workers(x: Tensor, t: Tensor, num_workers: int) -> tuple[Tensor, Tensor]:
    """Uniformly divide column-stacked data over M disjoint workers
    (paper §III-B: 'uniformly divide the training dataset')."""
    j = x.shape[1]
    per = j // num_workers
    x = x[:, : per * num_workers]
    t = t[:, : per * num_workers]
    xw = x.reshape(x.shape[0], num_workers, per).permute(1, 0, 2)
    tw = t.reshape(t.shape[0], num_workers, per).permute(1, 0, 2)
    return xw, tw


def partition_workers_noniid(
    x: Tensor, t: Tensor, num_workers: int, alpha: float = 1.0
) -> tuple[Tensor, Tensor]:
    """Non-IID split with label skew ``alpha`` in (0, 1].

    ``alpha`` is the fraction of each worker's shard drawn from the
    class-sorted sample stream as a contiguous block (so the worker sees
    only a few classes there); the remaining ``1 - alpha`` fraction is
    strided across the leftover stream, which spans all classes evenly.
    ``alpha=1`` (default) is the fully sorted split.  Consensus ADMM
    solves the GLOBAL problem whatever the split, so centralized
    equivalence is distribution-free.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"noniid alpha must be in (0, 1], got {alpha}")
    labels = torch.argmax(t, dim=0)
    order = torch.argsort(labels, stable=True)
    if alpha == 1.0:
        return partition_workers(x[:, order], t[:, order], num_workers)
    j = x.shape[1]
    per = j // num_workers
    n_skew = int(round(alpha * per))
    n_iid = per - n_skew
    used = per * num_workers
    order = order[:used].cpu().numpy()
    # Mark n_iid of every per consecutive stream positions as the IID
    # pool, evenly spread over the whole class-sorted stream.
    p = np.arange(used)
    iid_mark = ((p + 1) * n_iid) // per - (p * n_iid) // per == 1
    # IID pool strided across workers (each worker spans all classes)...
    iid_idx = order[iid_mark].reshape(n_iid, num_workers).T if n_iid else None
    # ...skew pool as contiguous class blocks (few classes per worker).
    skew_idx = order[~iid_mark].reshape(num_workers, n_skew)
    idx = torch.from_numpy(
        skew_idx if iid_idx is None
        else np.concatenate([skew_idx, iid_idx], axis=1)
    ).to(x.device)
    return x[:, idx].permute(1, 0, 2), t[:, idx].permute(1, 0, 2)


#: ``--partition`` spec names (see ``partition_by_spec``).
PARTITIONS = ("iid", "noniid")


def partition_by_spec(
    x: Tensor, t: Tensor, num_workers: int, spec: str = "iid"
) -> tuple[Tensor, Tensor]:
    """Partition specs: ``iid | noniid[:alpha]``, the single dispatcher
    behind ``train_dssfn --partition`` and ``TrainSpec(partition=...)``."""
    name, _, rest = spec.partition(":")
    if name == "iid":
        if rest:
            raise ValueError(f"bad partition spec {spec!r}: iid takes no args")
        return partition_workers(x, t, num_workers)
    if name == "noniid":
        try:
            alpha = float(rest) if rest else 1.0
            return partition_workers_noniid(x, t, num_workers, alpha=alpha)
        except ValueError as e:
            raise ValueError(f"bad partition spec {spec!r}: {e}") from e
    raise ValueError(
        f"unknown partition {name!r}; expected one of {PARTITIONS} "
        f"(spec {spec!r})"
    )
