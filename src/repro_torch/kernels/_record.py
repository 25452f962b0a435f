"""The hook through which a kernel wrapper reports a launch to a recording.

The hand-written kernels launch through ``ctypes``, below PyTorch's
dispatcher, so a ``TorchFunctionMode`` recording
(:mod:`repro_torch.analysis.numerics`) sees the wrapper's allocations
but not the kernel.  Each ``*_cuda`` wrapper therefore calls :data:`hook`
where it counts its launch::

    if _record.hook is not None:
        _record.hook(NAME, ACCUM_DTYPE, outputs)

``hook`` is None unless a recording is active, so a launch outside one
costs that single test.  The recording sets it for its duration and puts
back what it found.  The arguments are the kernel's name, the dtype it
accumulates in (a constant each wrapper declares) and its results.
"""
from __future__ import annotations

from typing import Callable

#: ``hook(name, accum_dtype, outputs)`` while a recording is active, else None.
hook: "Callable | None" = None
