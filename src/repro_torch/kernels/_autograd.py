"""The guard every public kernel op runs first: no op has a backward.

``repro``'s Pallas kernels define no VJP, so ``jax.grad`` through a
model with ``use_pallas_kernels`` raises; its training takes the plain
path.  The port's CUDA wrappers write their results through
``data_ptr``, so a result would carry no ``grad_fn`` and the gradient of
everything upstream of it would silently drop out.  Each op therefore
refuses, on every device, to run where autograd would record it.
"""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and any of ``tensors``
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward, in repro or in this port: it cannot run on "
            "tensors that require grad.  Training takes the plain path "
            "(use_pallas_kernels=False), as repro's does; run inference under "
            "torch.no_grad()."
        )
