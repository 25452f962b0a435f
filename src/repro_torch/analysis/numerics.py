"""Numerics lint over a record of the calls a program makes.

Port of ``repro/analysis/numerics.py``.  The reference lints the
pre-optimization StableHLO of a lowered program.  PyTorch runs eagerly
and lowers nothing, so the port runs the program once under
:func:`recording` and lints the record instead.  The record holds each
call the port's code writes, as a ``torch.overrides.TorchFunctionMode``
sees it, with no aten decomposition: the call's name (``a + b`` is
``add``, ``a @ b`` is ``matmul``), its result dtypes and its result
shapes.  That is the level of the reference's pre-optimization StableHLO:
a dtype is the one the code asked for.  A ``TorchDispatchMode`` would see
aten ops instead, below decompositions and autograd, where a library call
such as ``torch.linalg.cholesky`` shows as its parts and the call the
code wrote cannot be told from them.

The hand-written kernels launch through ``ctypes``, below the
dispatcher, so neither mode sees them.  Each ``*_cuda`` wrapper reports
its launch through :data:`repro_torch.kernels._record.hook`, with the
dtype it accumulates in, and the record holds it as ``kernel:<name>``.

Two rules:

- **low-precision accumulation** (``numerics-accum``): an accumulating
  call (``add``, ``sum``, ``mean``, ``matmul``, ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``einsum``, ``index_add_``, ``scatter_add_``
  and their in-place forms) whose RESULT is bf16/f16, the reference's
  convention; a kernel by the dtype it declares it accumulates in.  The
  wire-format contract is "cast once onto the wire, accumulate in f32":
  a half-precision accumulate means a missing f32 convert on the receive
  path.
- **unguarded cholesky** (``numerics-cholesky``): a factorization
  (``torch.linalg.cholesky``, ``torch.linalg.cholesky_ex``,
  ``torch.cholesky``) not called from within
  :func:`repro_torch.core.admm.guarded_cholesky`, the escalating-jitter
  retry.  The caller is read off the Python stack at the call, and only
  while recording.  This is stricter than the reference's rule (some
  cholesky inside a ``while`` region), which passes a program with one
  guarded and one raw factorization; here every factorization must be
  guarded.

Nothing replaces the reference's ``lint_stablehlo_text``: there is no
program text to parse, and :func:`lint_record` takes the record itself.
"""
from __future__ import annotations

import collections
import contextlib
import sys
from dataclasses import dataclass, field
from typing import Iterator

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.kernels import _record

from .findings import LintFinding

_LOW_PRECISION = {"bf16", "f16"}

#: Calls that ACCUMULATE (reassociate sums); pure data movement (``to``,
#: ``index_select``, ``cat``, ...) may be any width.
ACCUM_CALLS = frozenset({
    "add", "add_", "sum", "mean", "matmul", "mm", "bmm", "addmm", "addmm_",
    "baddbmm", "baddbmm_", "einsum", "index_add", "index_add_",
    "scatter_add", "scatter_add_",
})

#: Factorizations that must go through ``admm.guarded_cholesky``.
FACTORIZATIONS = frozenset({"linalg_cholesky", "linalg_cholesky_ex", "cholesky"})

#: Op namespaces of ``torch.distributed``'s dispatched collectives.
_COLLECTIVE_PREFIXES = ("c10d::", "_c10d_functional::", "c10d_functional::")

_SHORT_DTYPES = {
    torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float64: "f64", torch.int64: "i64", torch.int32: "i32",
    torch.int16: "i16", torch.int8: "i8", torch.uint8: "ui8", torch.bool: "i1",
}

_DUNDERS = {
    "__add__": "add", "__radd__": "add", "__iadd__": "add_",
    "__matmul__": "matmul", "__rmatmul__": "matmul",
}


def short_dtype(dtype: torch.dtype) -> str:
    """StableHLO's element-type spelling (``f32``, ``bf16``, ``i64``)."""
    return _SHORT_DTYPES.get(dtype, str(dtype).removeprefix("torch."))


@dataclass(frozen=True)
class CallRecord:
    """One recorded call: its name, result dtypes and shapes; a kernel's
    declared accumulation dtype; whether a factorization ran under
    ``guarded_cholesky``."""

    name: str
    dtypes: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    accum_dtype: str | None = None
    guarded: bool | None = None

    @property
    def is_kernel(self) -> bool:
        return self.name.startswith("kernel:")

    @property
    def is_collective(self) -> bool:
        return self.name.startswith(_COLLECTIVE_PREFIXES)

    def render(self) -> str:
        outs = ", ".join(
            f"{d}[{','.join(map(str, s))}]" for d, s in zip(self.dtypes, self.shapes)
        )
        line = f"{self.name} -> {outs}"
        if self.accum_dtype is not None:
            line += f" accumulates {self.accum_dtype}"
        if self.guarded is not None:
            line += " guarded" if self.guarded else " unguarded"
        return line


@dataclass
class ProgramRecord:
    """The calls one run of a program made, in order."""

    calls: list = field(default_factory=list)

    def counts(self) -> dict:
        """Calls by name."""
        return dict(collections.Counter(c.name for c in self.calls))

    def kernels(self) -> list:
        return [c for c in self.calls if c.is_kernel]

    def render(self) -> str:
        """One line per call, ``index: name -> dtype[shape], ...``."""
        return "\n".join(f"{i}: {c.render()}" for i, c in enumerate(self.calls))

    def add_kernel(self, name: str, accum_dtype: torch.dtype, outputs) -> None:
        """The kernel wrappers' hook (:mod:`repro_torch.kernels._record`)."""
        tensors = _tensors(outputs)
        self.calls.append(CallRecord(
            f"kernel:{name}",
            tuple(short_dtype(t.dtype) for t in tensors),
            tuple(tuple(t.shape) for t in tensors),
            accum_dtype=short_dtype(accum_dtype),
        ))


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _call_name(func) -> str:
    name = getattr(func, "__name__", None) or type(func).__name__
    if name == "__get__":  # a property such as ``.mT``
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    module = getattr(func, "__module__", None) or ""
    if module.startswith("torch._ops."):  # torch.ops.<namespace>.<op>
        return f"{module.removeprefix('torch._ops.')}::{name}"
    return _DUNDERS.get(name, name)


def _under_guard() -> bool:
    """Whether ``admm.guarded_cholesky`` is on the Python stack."""
    from repro_torch.core import admm

    code = admm.guarded_cholesky.__code__
    frame = sys._getframe(1)
    while frame is not None:
        if frame.f_code is code:
            return True
        frame = frame.f_back
    return False


class _Recorder(TorchFunctionMode):
    def __init__(self, record: ProgramRecord):
        super().__init__()
        self.record = record

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = _tensors(out)
        if tensors:
            name = _call_name(func)
            self.record.calls.append(CallRecord(
                name,
                tuple(short_dtype(t.dtype) for t in tensors),
                tuple(tuple(t.shape) for t in tensors),
                guarded=_under_guard() if name in FACTORIZATIONS else None,
            ))
        return out


@contextlib.contextmanager
def recording() -> Iterator[ProgramRecord]:
    """Record every call made inside the block, kernel launches included::

        with recording() as record:
            program(*args)
        findings = lint_record(record, subject="program")
    """
    record = ProgramRecord()
    previous = _record.hook
    _record.hook = record.add_kernel
    try:
        with _Recorder(record):
            yield record
    finally:
        _record.hook = previous


def lint_record(record: ProgramRecord, *, subject: str) -> list[LintFinding]:
    findings: list[LintFinding] = []
    unguarded = []
    for i, call in enumerate(record.calls):
        if call.name in FACTORIZATIONS and not call.guarded:
            unguarded.append(i)
        if call.is_kernel:
            dtype = call.accum_dtype
        elif call.name in ACCUM_CALLS:
            dtype = call.dtypes[0]
        else:
            continue
        if dtype in _LOW_PRECISION:
            findings.append(LintFinding(
                check="numerics-accum",
                subject=subject,
                message=(
                    f"{call.name} accumulates in {dtype} (call {i}); "
                    "wire payloads must be accumulated in f32 — cast "
                    "on the wire only, convert back before the add"
                ),
                details={"call": i, "op": call.name, "dtype": dtype,
                         "text": call.render()[:200]},
            ))
    if unguarded:
        findings.append(LintFinding(
            check="numerics-cholesky",
            subject=subject,
            message=(
                "cholesky factorization outside the guarded path: not "
                "called from admm.guarded_cholesky's escalating-jitter "
                "retry — a non-PD Gram returns NaN factors unchecked"
            ),
            details={"sites": unguarded},
        ))
    return findings


def lint_callable(fn, *example_args, subject: str) -> list[LintFinding]:
    """Run ``fn`` once on ``example_args`` under :func:`recording` and
    lint its record (the reference's ``lint_jax_callable`` traces
    without running)."""
    with recording() as record:
        fn(*example_args)
    return lint_record(record, subject=subject)


def lint_backend_program(
    backend, fn, *stacked_args, replicated=(), key=None, policy=None,
    subject: str,
) -> list[LintFinding]:
    """Lint a worker program exactly as the backend runs it; it joins the
    backend's program record as :meth:`run` would."""
    texts = backend.lowering_texts(
        fn, *stacked_args, replicated=replicated, key=key, policy=policy,
    )
    return lint_record(texts["program"], subject=subject)
