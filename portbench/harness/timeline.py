"""The card's timeline from ``torch.profiler``, and what is read from it.

:func:`profiled` runs a block under the profiler with only the device's
activity recorded (kernels, copies and fills through CUPTI), which costs
the host the least, and returns every device operation as
``(name, start_ns, end_ns)`` in Unix nanoseconds, the clock of
:mod:`portbench.harness.spans`.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch


def profiled(fn):
    """(fn(), device ops) with fn run under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ops = []
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = event.start_ns()
        ops.append((event.name(), start, start + event.duration_ns()))
    ops.sort(key=lambda op: op[1])
    return out, ops


def warm_profiler() -> None:
    """Start and stop the profiler once, so CUPTI's own set-up falls
    outside the phases that are read."""
    profiled(lambda: torch.zeros(1, device="cuda").add_(1))


def busy_intervals(ops, start_ns: int, end_ns: int) -> list:
    """The union of the device ops' intervals, clipped to the window."""
    merged = []
    for _, s, e in ops:
        s, e = max(s, start_ns), min(e, end_ns)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_ns(ops, start_ns: int, end_ns: int) -> int:
    return sum(e - s for s, e in busy_intervals(ops, start_ns, end_ns))


def idle_gaps(ops, start_ns: int, end_ns: int) -> list:
    """(start_ns, end_ns) of every stretch of the window with no device op."""
    gaps, at = [], start_ns
    for s, e in busy_intervals(ops, start_ns, end_ns):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if end_ns > at:
        gaps.append((at, end_ns))
    return gaps


class Starts:
    """The ops (sorted by start) with their start times, for
    :func:`device_ns_within`."""

    def __init__(self, ops):
        self.ops = ops
        self.starts = [op[1] for op in ops]


def device_ns_within(index: Starts, start_ns: int, end_ns: int) -> int:
    """Device time of the ops that ran inside [start_ns, end_ns]: those a
    span that waits for the card at both ends launched."""
    ops, total = index.ops, 0
    for i in range(bisect.bisect_left(index.starts, start_ns), len(ops)):
        _, s, e = ops[i]
        if s >= end_ns:
            break
        total += min(e, end_ns) - s
    return total


def top_ops(ops, count: int = 10) -> list:
    """[[name, seconds], ...]: the device ops that took the most time,
    summed by name."""
    by_name = defaultdict(int)
    for name, s, e in ops:
        by_name[name] += e - s
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[name, ns / 1e9] for name, ns in ranked]


def label_gaps(gaps, spans, order, outside: str, count: int = 10) -> list:
    """[[label, seconds], ...]: idle time summed by what the host was in
    at each gap's middle: the first layer of ``order`` (innermost first)
    whose span holds it, or ``outside`` where none does.  Spans of one
    layer do not overlap."""
    by_name = {}
    for name in order:
        mine = sorted((sp.start_ns, sp.end_ns) for sp in spans if sp.name == name)
        by_name[name] = ([s for s, _ in mine], [e for _, e in mine])
    totals = defaultdict(int)
    for s, e in gaps:
        mid = (s + e) // 2
        label = outside
        for name in order:
            starts, ends = by_name[name]
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid < ends[i]:
                label = name
                break
        totals[label] += e - s
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:count]
    return [[label, ns / 1e9] for label, ns in ranked]
