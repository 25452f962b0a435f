"""Optimizers for the model zoo (port of ``repro/optim/optimizers.py``).

``init(params)`` and ``update(params, grads, state) -> (params, state)``
over the port's parameter trees, in ``repro``'s state layout:
``{"step": int32 0-d, "m": ..., "v": ...}``, the moments in f32 and the
params kept in their own dtype.

Where ``repro``'s functions return new trees, ``update`` writes the new
values into ``params`` and into the state's moments in place and returns
those same tensors with a new ``step``: at published width a second copy
of the moments does not fit beside the first (H2O-Danube3-4B's are 31.7
GB).  It works leaf by leaf, so the f32 temporaries of one leaf are gone
before the next begins.  Every expression rounds as ``repro``'s does: a
product is rounded on its own and then added (``mul_`` then ``add_``,
never a fused ``lerp``, ``addcmul`` or ``alpha=``), and the bias
corrections ``1 - b ** step`` are f32 0-d tensors, so that dividing by
them is a true division on the card too (CUDA turns a division by a
Python scalar into a multiply by its reciprocal).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import _tree


class Optimizer:
    def init(self, params) -> Any:
        raise NotImplementedError

    def update(self, params, grads, state):
        raise NotImplementedError


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_tree.leaves(params)[0].device)


def _zeros_f32(params):
    return _tree.map_(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


@dataclass(frozen=True)
class Sgd(Optimizer):
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "m": _zeros_f32(params)}

    @torch.no_grad()
    def update(self, params, grads, state):
        step = state["step"] + 1
        if self.momentum == 0.0:
            for p, g in zip(_tree.leaves(params), _tree.leaves(grads), strict=True):
                p.copy_(p.float() - self.lr * g.float())
            return params, {"step": step}
        for p, g, m in zip(_tree.leaves(params), _tree.leaves(grads),
                           _tree.leaves(state["m"]), strict=True):
            m.mul_(self.momentum).add_(g.float())
            p.copy_(p.float() - self.lr * m)
        return params, {"step": step, "m": state["m"]}


@dataclass(frozen=True)
class AdamW(Optimizer):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        return {"step": _step0(params), "m": _zeros_f32(params), "v": _zeros_f32(params)}

    @torch.no_grad()
    def update(self, params, grads, state):
        step = state["step"] + 1
        t = step.float()

        def correction(b):
            return 1.0 - torch.pow(torch.full((), b, dtype=torch.float32, device=t.device), t)

        b1c, b2c = correction(self.b1), correction(self.b2)
        for p, g, m, v in zip(_tree.leaves(params), _tree.leaves(grads),
                              _tree.leaves(state["m"]), _tree.leaves(state["v"]),
                              strict=True):
            g32 = g.float()
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            g2 = g32 * (1 - self.b2)
            v.mul_(self.b2).add_(g2.mul_(g32))          # ((1 - b2) g) g
            del g32, g2
            den = (v / b2c).sqrt_().add_(self.eps)      # sqrt(v^) + eps
            delta = (m / b1c).div_(den)
            del den
            p32 = p.float()
            if self.weight_decay:
                delta.add_(p32 * self.weight_decay)
            p.copy_(torch.sub(p32, delta.mul_(self.lr), out=delta))
        return params, {"step": step, "m": state["m"], "v": state["v"]}
