"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and where CUDA is absent that
raises instead of continuing on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises, naming
    the ``device="cpu"`` remedy."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait until every queued operation on ``device`` has finished (the
    counterpart of ``jax.block_until_ready``); a no-op on the CPU, whose
    operations are synchronous."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(array: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A host array as a tensor on ``device``.  A copy to the card goes
    through pinned memory without waiting for the card's queue (a copy
    from pageable memory would synchronize the stream)."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def exact_div(x: torch.Tensor, divisor) -> torch.Tensor:
    """``x / divisor`` as IEEE division on every device.  CUDA turns a
    division by a Python scalar into a multiply by its reciprocal, which
    rounds differently from the CPU's division and from the reference's;
    a scalar divisor therefore becomes a tensor (rounded to ``x``'s
    dtype) on ``x``'s device."""
    if not isinstance(divisor, torch.Tensor):
        divisor = torch.full((), divisor, dtype=x.dtype, device=x.device)
    return x / divisor
