"""FLOPs, HBM traffic, live memory and collectives of one call of a program.

The twin of ``repro/launch/hlo_analysis.py``.  The reference parses the
compiled HLO text of a lowered program; PyTorch lowers nothing, so
:func:`analyze_call` runs the program once under :class:`CostMode`, a
``TorchDispatchMode`` that sees every aten op the call dispatches, on
fake, meta or real tensors (under ``FakeTensorMode`` nothing is
allocated and no device is touched).  The result follows ``repro``'s
``ModuleAnalysis``: ``flops``, ``traffic_bytes``, ``collectives``,
``collective_wire_bytes``, ``collective_by_type()`` and
``collective_counts()``, plus ``peak_live_bytes``, ``output_bytes`` and a
per-op breakdown (``by_op``).

- **FLOPs**: the registry of ``torch.utils.flop_counter`` (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention), decomposing
  other ops as ``FlopCounterMode`` does, so a count equals
  ``FlopCounterMode``'s on the same call.  Like ``hlo_analysis``, which
  counts ``dot`` only, it leaves Cholesky factors and triangular solves
  uncounted.
- **Kernels**: a hand-written kernel launches through ``ctypes``, below
  the dispatcher, and reports itself through
  :data:`repro_torch.kernels._record.hook` with its inputs.  The mode
  then runs the kernel's plain version on ``meta`` copies of them and
  credits the launch with that version's FLOPs and traffic, so the kernel
  route and the plain route of one program count the same.
- **Traffic**: the bytes of every op's output, written once (an in-place
  op writes its output too); views, metadata queries and bare
  allocations (``empty`` and the like) write nothing and are left out.
  These are the eager program's own writes.  ``repro``'s write-once model
  counts the ops of a fused HLO module, so the two differ by design and
  are not held equal.
- **Peak**: the largest sum of the bytes of live storages made during the
  call: a storage's bytes are added when an op makes it and taken away
  when it is freed (a ``weakref.finalize`` on the storage).  Inputs made
  before the call are not counted.
- **Collectives**: :class:`CollectiveOp` with ``repro``'s ring formulas
  (:func:`_wire_bytes`, copied).  Nothing here runs a collective:
  they are recorded by a :class:`CountingTransport` standing in for a
  ``launch/mesh.Transport``, or added by a planner from its plan.
- **Loop multipliers**: ``repro`` reads while-loop trip counts from the
  HLO.  The port's loops are Python loops that the trace unrolls, so a
  planner traces a program at two repeat counts (a config cut in depth)
  and :func:`extrapolate` extends every count linearly to the full
  count.

No counterpart: the HLO text parsers (``_type_bytes``,
``_max_shape_bytes``, ``_COMP_START_RE``, ``_group_size``,
``parse_collectives``); ``analyze_module(text)`` is
:func:`analyze_call`.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _record
from repro_torch.launch.mesh import TransportStats


def _wire_bytes(op: str, result_bytes: int, g: int) -> float:
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return float(result_bytes * (g - 1))
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)


@dataclass
class CollectiveOp:
    op: str
    computation: str
    result_bytes: int
    group_size: int
    multiplier: int = 1

    @property
    def wire_bytes(self) -> float:
        return self.multiplier * _wire_bytes(self.op, self.result_bytes, self.group_size)


@dataclass
class OpCost:
    """One op's share of a call: its calls, FLOPs and bytes written."""

    calls: float = 0
    flops: float = 0
    traffic_bytes: float = 0


@dataclass
class ModuleAnalysis:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collectives: list[CollectiveOp] = field(default_factory=list)
    #: The largest sum of live bytes made during the call.
    peak_live_bytes: float = 0
    #: Bytes of the call's results made during it.
    output_bytes: float = 0
    #: By aten op (``aten.mm.default``) or kernel launch (``kernel:gram``).
    by_op: dict[str, OpCost] = field(default_factory=dict)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.collectives)

    def collective_by_type(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for o in self.collectives:
            out[o.op] = out.get(o.op, 0.0) + o.wire_bytes
        return out

    def collective_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for o in self.collectives:
            out[o.op] = out.get(o.op, 0) + o.multiplier
        return out


#: Queries of a tensor's metadata: no data is read or written.
_METADATA_OPS = {
    torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default, torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}

#: Allocations that write nothing.
_ALLOCATIONS = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _returns(info, out) -> list:
    """``(tensor, alias_info)`` for each tensor the op returns."""
    if info.list_return:
        return [(t, info.aliases[0]) for t in out if isinstance(t, torch.Tensor)]
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [(t, a) for t, a in zip(outs, info.aliases) if isinstance(t, torch.Tensor)]


@dataclass(frozen=True)
class _OpInfo:
    """What the mode needs of an op's schema, read once per op."""

    name: str
    aliases: tuple
    list_return: bool

    @property
    def fresh(self) -> bool:
        """Every result is a new tensor (no view, no in-place write)."""
        return all(a is None for a in self.aliases)


def _op_info(func) -> _OpInfo:
    rets = func._schema.returns
    return _OpInfo(str(func), tuple(r.alias_info for r in rets),
                   len(rets) == 1 and str(rets[0].type).startswith("List"))


_ATOM_TYPES = frozenset({int, float, bool, str, type(None), torch.dtype, torch.device,
                         torch.layout, torch.memory_format})


def _key_parts(x, out: list) -> bool:
    """Append a hashable form of ``x`` to ``out``; False where ``x`` holds
    anything but ``meta`` tensors (themselves, not fake tensors) and
    plain values."""
    t = type(x)
    if t is torch.Tensor:
        if x.device.type != "meta":
            return False
        out.append((x.shape, x.stride(), x.storage_offset(), x.dtype))
        return True
    if t is tuple or t is list:
        out.append(len(x))
        return all(_key_parts(v, out) for v in x)
    if t in _ATOM_TYPES:
        out.append((t, x))
        return True
    return False


def _meta_key(func, args, kwargs):
    """A hashable key of an op and its ``meta`` arguments' metadata, or
    None where an argument is anything else."""
    out = [func]
    if not _key_parts(args, out):
        return None
    for k in sorted(kwargs):
        out.append(k)
        if not _key_parts(kwargs[k], out):
            return None
    return tuple(out)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _plain_version(name: str) -> Callable:
    """The plain PyTorch version of a kernel, by the name it reports."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.matmul_relu.ref import matmul_relu_ref
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
    from repro_torch.kernels.propagate_gram.ref import propagate_gram_ref
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

    return {"matmul_relu": matmul_relu_ref, "gram": gram_ref,
            "propagate_gram": propagate_gram_ref, "flash_attention": flash_attention_ref,
            "ssm_scan": ssm_scan_ref, "mlstm_scan": mlstm_scan_ref}[name]


def _on_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
    if isinstance(x, (tuple, list)):
        return type(x)(_on_meta(v) for v in x)
    if isinstance(x, dict):
        return {k: _on_meta(v) for k, v in x.items()}
    return x


class CostMode(TorchDispatchMode):
    """Counts FLOPs, written bytes and live bytes of every op dispatched
    while it is active, into ``self.analysis``.

    ``product_scale(func, args, out)``, where given, is the share of an
    op with FLOPs (a product) that one device computes: a planner counts a
    product with a tensor-parallel weight at 1/model of its FLOPs and
    bytes.
    """

    def __init__(self, *, product_scale: Callable | None = None):
        super().__init__()
        self.analysis = ModuleAnalysis()
        self.product_scale = product_scale
        self._live = 0
        self._made: dict[int, int] = {}
        self._credit: str | None = None
        # The schema facts of each op seen that does not decompose, and the
        # results' metadata of each (op, meta arguments) seen: a meta
        # kernel's result depends on its arguments' metadata alone, and
        # many run in Python (hundreds of microseconds an elementwise op),
        # so a repeat makes fresh meta tensors of the recorded shapes
        # instead (as FakeTensorMode's dispatch cache does).
        self._ops: dict = {}
        self._meta_results: dict = {}

    def _add(self, name: str, flops: float, nbytes: float, calls: int = 1) -> None:
        a = self.analysis
        a.flops += flops
        a.traffic_bytes += nbytes
        cost = a.by_op.setdefault(name, OpCost())
        cost.calls += calls
        cost.flops += flops
        cost.traffic_bytes += nbytes

    def _freed(self, key: int) -> None:
        self._live -= self._made.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._made:
            return
        nbytes = st.nbytes()
        self._made[key] = nbytes
        self._live += nbytes
        self.analysis.peak_live_bytes = max(self.analysis.peak_live_bytes, self._live)
        weakref.finalize(st, self._freed, key)

    def made_during(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made during the recording and lives."""
        return _storage_key(t) in self._made

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA_OPS:
            return func(*args, **kwargs)
        info = self._ops.get(func)
        if info is None:
            if func is not torch.ops.prim.device.default:
                # FlopCounterMode's rule: count the parts of an op that
                # decomposes (an op with its own kernel returns NotImplemented).
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
            info = self._ops[func] = _op_info(func)
        key = _meta_key(func, args, kwargs) if info.fresh else None
        cached = self._meta_results.get(key) if key is not None else None
        if cached is not None:
            kind, metas = cached
            out = [torch.empty_strided(s, st, dtype=d, device="meta") for s, st, d in metas]
            out = out[0] if kind is torch.Tensor else kind(out)
        else:
            out = func(*args, **kwargs)
            if key is not None:
                outs = [out] if isinstance(out, torch.Tensor) else out
                if type(outs) in (list, tuple) and all(
                        type(t) is torch.Tensor and t.device.type == "meta" for t in outs):
                    self._meta_results[key] = (type(out), [
                        (tuple(t.shape), t.stride(), t.dtype) for t in outs])
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        written = 0
        for t, alias in _returns(info, out):
            if alias is None:
                if self._credit is None:
                    self._track(t)
                if func not in _ALLOCATIONS:
                    written += _nbytes(t)
            elif alias.is_write:
                written += _nbytes(t)
        if self._credit is not None:
            self._add(self._credit, flops, written, calls=0)
            return out
        scale = 1
        if flops and self.product_scale is not None:
            scale = self.product_scale(func, args, out)
        self._add(info.name, flops * scale, written * scale)
        return out

    def kernel_hook(self, previous: Callable | None) -> Callable:
        """A :data:`repro_torch.kernels._record.hook` that credits a launch
        with its plain version's FLOPs and traffic (run on ``meta`` copies
        of the launch's inputs), then calls ``previous``."""

        def hook(name, accum_dtype, outputs, inputs=None):
            if inputs is None:
                raise ValueError(f"kernel {name} reported no inputs to size its launch by")
            args, kwargs = inputs
            key = f"kernel:{name}"
            self._credit = key
            try:
                _plain_version(name)(*_on_meta(args), **_on_meta(kwargs))
            finally:
                self._credit = None
            self.analysis.by_op.setdefault(key, OpCost()).calls += 1
            if previous is not None:
                previous(name, accum_dtype, outputs, inputs)

        return hook


def analyze_call(fn: Callable, *args, product_scale: Callable | None = None, **kwargs):
    """``(fn(*args, **kwargs), ModuleAnalysis)`` of one call of ``fn``,
    kernel launches included."""
    mode = CostMode(product_scale=product_scale)
    previous = _record.hook
    _record.hook = mode.kernel_hook(previous)
    try:
        with mode:
            out = fn(*args, **kwargs)
        mode.analysis.output_bytes = sum(
            {_storage_key(t): t.untyped_storage().nbytes()
             for t in _tensors(out) if mode.made_during(t)}.values())
    finally:
        _record.hook = previous
    return out, mode.analysis


class CountingTransport:
    """The ``all_reduce``, ``size`` and ``stats`` of a ``launch/mesh``
    ``Transport``, for running ONE rank's share of a program alone, as if
    the other ``size - 1`` ranks held the same values: ``all_reduce``
    returns ``x * size`` (so a mean keeps the local values), counts what
    it would carry in ``stats`` as the transport does, and records a
    :class:`CollectiveOp` in ``collectives``.  Nothing crosses a process.
    """

    def __init__(self, size: int):
        self.size = size
        self.stats = TransportStats()
        self.collectives: list[CollectiveOp] = []

    def all_reduce(self, x: torch.Tensor, op: str = "sum", *, kind: str = "all-reduce"):
        if op != "sum":
            raise ValueError(f"a counting transport simulates sums only, got {op!r}")
        nbytes = _nbytes(x)
        s = self.stats
        s.counts[kind] = s.counts.get(kind, 0) + 1
        s.bytes[kind] = s.bytes.get(kind, 0) + nbytes
        dkey = (kind, str(x.dtype).removeprefix("torch."))
        s.dtypes[dkey] = s.dtypes.get(dkey, 0) + 1
        self.collectives.append(CollectiveOp(kind, "transport", nbytes, self.size))
        return x * self.size


def _line(a, b, n_a, n_b, n):
    """The value at ``n`` of the line through ``(n_a, a)`` and ``(n_b, b)``,
    exact in fractions (an int where the result is whole)."""
    v = Fraction(a) + (Fraction(b) - Fraction(a)) * Fraction(n - n_a, n_b - n_a)
    return int(v) if v.denominator == 1 else float(v)


def extrapolate(trace_a: ModuleAnalysis, trace_b: ModuleAnalysis, n_a, n_b, n) -> ModuleAnalysis:
    """The analysis at repeat count (or length) ``n`` from two traces at
    ``n_a`` and ``n_b`` (the counterpart of ``repro``'s loop trip counts).
    Exact where the program's counts are linear in it (FLOPs, traffic,
    calls, collectives, results' bytes); the live peak is extended the
    same way, which is exact where both traces and the full program peak
    in the same phase."""

    def line(a, b):
        return _line(a, b, n_a, n_b, n)

    by_op = {}
    for key in sorted(set(trace_a.by_op) | set(trace_b.by_op)):
        a, b = trace_a.by_op.get(key, OpCost()), trace_b.by_op.get(key, OpCost())
        by_op[key] = OpCost(line(a.calls, b.calls), line(a.flops, b.flops),
                            line(a.traffic_bytes, b.traffic_bytes))

    def groups(trace):
        out: dict = {}
        for c in trace.collectives:
            k = (c.op, c.computation, c.result_bytes, c.group_size)
            out[k] = out.get(k, 0) + c.multiplier
        return out

    ga, gb = groups(trace_a), groups(trace_b)
    collectives = [CollectiveOp(*k, line(ga.get(k, 0), gb.get(k, 0)))
                   for k in sorted(set(ga) | set(gb))]
    return ModuleAnalysis(
        flops=line(trace_a.flops, trace_b.flops),
        traffic_bytes=line(trace_a.traffic_bytes, trace_b.traffic_bytes),
        collectives=[c for c in collectives if c.multiplier],
        peak_live_bytes=line(trace_a.peak_live_bytes, trace_b.peak_live_bytes),
        output_bytes=line(trace_a.output_bytes, trace_b.output_bytes),
        by_op=by_op,
    )
