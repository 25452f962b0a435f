"""Deprecated shim: import from :mod:`repro_torch.core.policy` instead.

Port of ``repro/core/robust.py``.  Every name this module exports lives
in ``repro_torch.core.policy`` (which also re-exports the quantizers of
``repro_torch.core.consensus``).  The Byzantine-robust policies
(``TrimmedMeanGossip``, ``MedianGossip``, ``ClippedGossip``) were never
published here; use the canonical module.  Importing this shim raises a
:class:`DeprecationWarning`.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.core.robust is deprecated; import consensus policies and "
    "quantizers from repro_torch.core.policy",
    DeprecationWarning,
    stacklevel=2,
)

from repro_torch.core.policy import (  # noqa: F401,E402  (re-exports)
    LossyGossip,
    QuantizedGossip,
    StaleMixing,
    quantize_nearest,
    quantize_stochastic,
)

__all__ = [
    "LossyGossip",
    "QuantizedGossip",
    "StaleMixing",
    "quantize_nearest",
    "quantize_stochastic",
]
