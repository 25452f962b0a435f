"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``cuda``, and where CUDA is absent that
raises instead of continuing on the CPU.
"""
from __future__ import annotations

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
