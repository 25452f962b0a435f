"""Spans around the calls into the program's layers, from outside it,
and the trace of a run that the per-layer readers read.

The traced run rebinds module attributes of ``repro_torch`` for the
length of a phase and puts back what it found; nothing in the program is
edited, and a run with ``--trace 0`` installs nothing.  Each span keeps
its host times in Unix nanoseconds (``time.time_ns``, the clock of
``torch.profiler``'s events) and the work its call does, counted from the
call's shapes (:mod:`portbench.harness.work`).

Layers, by the name a span carries:

- ``layer_stats``: ``core.engine._propagate_and_stats`` (layers >= 1) and
  ``core.admm._worker_stats`` (layer 0), which the layer engine calls by
  module attribute;
- ``admm``: ``core.admm.worker_admm_iterations``;
- ``mix``: the ``mix`` method of the cell's consensus policy class.

A synchronized span waits for the card at both ends, so its host time is
the card time of its work; the spans of the other layers in that phase do
not wait, so they change nothing of the timeline around them.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import work as work_lib

LAYERS = ("layer_stats", "admm", "mix")


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    work: work_lib.Work
    #: ADMM iterations the span ran (1 for the other layers).
    count: int = 1


@dataclass
class Trace:
    """What the per-layer readers (``metrics/*.py``) read."""
    config: dict = field(default_factory=dict)
    #: The window: whole trains, no span, no profiler.
    window_trains: int = 0
    window_s: float = 0.0
    train_work: work_lib.Work = work_lib.NONE
    #: Trains 1 and 2, no profiler: spans that wait for the card, the
    #: layer statistics and ADMM in one train, the mixes in the other.
    wall_spans: list = field(default_factory=list)
    #: Train 3: the profiled train's length and the card's busy time in it.
    timeline_ns: int = 0
    busy_ns: int = 0
    #: Train 4: (span, device ns of the ops inside it), every layer's
    #: spans waiting for the card.
    device_spans: list = field(default_factory=list)


class Recorder:
    """Collects the spans of one phase; ``sync`` names the layers whose
    spans wait for the card at both ends."""

    def __init__(self, sync: tuple = ()):
        unknown = set(sync) - set(LAYERS)
        if unknown:
            raise ValueError(f"no such layer: {sorted(unknown)}")
        self.sync = frozenset(sync)
        self.spans: list[Span] = []

    def wrap(self, name: str, fn, sizer):
        sync = name in self.sync

        def wrapped(*args, **kwargs):
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            start = time.time_ns()
            out = fn(*args, **kwargs)
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            end = time.time_ns()
            work, count = sizer(args, kwargs)
            self.spans.append(Span(name, start, end, work, count))
            return out

        return wrapped


def _stats_work(args, kwargs):
    if len(args) == 4:   # _propagate_and_stats(w, y_workers, t_workers, mu)
        w, y, t = args[:3]
        d, d_prev = w.shape
    else:                # _worker_stats(y_workers, t_workers, mu)
        y, t = args[:2]
        d, d_prev = y.shape[1], None
    m, _, jm = y.shape
    return work_lib.layer_stats(m, jm, t.shape[1], d, d_prev), 1


def _admm_sizer(exact: bool):
    def sizer(args, kwargs):
        # worker_admm_iterations(backend, a, chol, y_m, t_m, z_init, *, num_iters, trace_every, ...)
        a, y = args[1], args[3]
        m, q, d = a.shape
        jm = y.shape[2]
        k = kwargs["num_iters"]
        every = kwargs.get("trace_every", 1)
        traced = k // every if every else 0
        total = (
            work_lib.admm_iteration(m, jm, q, d, exact=exact, traced=True) * traced
            + work_lib.admm_iteration(m, jm, q, d, exact=exact, traced=False) * (k - traced)
        )
        return total, k
    return sizer


def _mix_sizer(exact: bool):
    def sizer(args, kwargs):
        x = args[1]      # mix(self, x, state, ctx)
        m, q, d = x.shape
        return work_lib.mix(m, q, d, exact), 1
    return sizer


@contextlib.contextmanager
def installed(recorder: Recorder, policy):
    """Wrap the program's layer calls for the length of the block."""
    from repro_torch.core import admm, engine

    exact = bool(policy.is_exact)
    targets = [
        (engine, "_propagate_and_stats", "layer_stats", _stats_work),
        (admm, "_worker_stats", "layer_stats", _stats_work),
        (admm, "worker_admm_iterations", "admm", _admm_sizer(exact)),
        (type(policy), "mix", "mix", _mix_sizer(exact)),
    ]
    saved = []
    try:
        for owner, attr, name, sizer in targets:
            original = owner.__dict__[attr]
            saved.append((owner, attr, original))
            setattr(owner, attr, recorder.wrap(name, original, sizer))
        yield recorder
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)
