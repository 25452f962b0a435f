"""The hook through which a kernel wrapper reports a launch to a recording.

The hand-written kernels launch through ``ctypes``, below PyTorch's
dispatcher, so a ``TorchFunctionMode`` or ``TorchDispatchMode``
recording (:mod:`repro_torch.analysis.numerics`,
:mod:`repro_torch.launch.cost_analysis`) sees the wrapper's allocations
but not the kernel.  Each ``*_cuda`` wrapper therefore calls :data:`hook`
where it counts its launch::

    if _record.hook is not None:
        _record.hook(NAME, ACCUM_DTYPE, outputs, (args, kwargs))

``hook`` is None unless a recording is active, so a launch outside one
costs that single test.  A recording sets it for its duration and puts
back what it found.  The arguments are the kernel's name, the dtype it
accumulates in (a constant each wrapper declares), its results, and its
inputs as the call of its plain version (``<name>_ref(*args, **kwargs)``)
that computes the same function, from which a recording can size the
launch's work.
"""
from __future__ import annotations

from typing import Callable

#: ``hook(name, accum_dtype, outputs, inputs)`` while a recording is active,
#: else None.
hook: "Callable | None" = None
