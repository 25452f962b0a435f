"""The driver of the dSSFN training cells: one run of a cell, its set-up,
the measured window, the traced phases, the check against the reference,
and the result line.  A cell names it (``"driver": "dssfn_train"`` in
``workloads/<cell>.json``).

The window is whole trains run back to back, each on its own inputs
drawn on the card from the seed (:mod:`portbench.harness.inputs`; the
draw is about a millisecond of a train's seconds).  It closes when the
first train that finishes after ``seconds`` is done, and ``train_s`` is
its wall time over the trains it holds.

With ``trace`` the window is followed by four more trains:

1. the layer-statistics and ADMM spans waiting for the card at both
   ends: their host times;
2. the mix spans waiting: their host times;
3. under ``torch.profiler`` (device activity only), with spans that do
   not wait for the card: the card's busy time and ``breakdown``, its
   idle gaps labelled by the span the host was in;
4. under the profiler, every span waiting for the card at both ends:
   the device time of the kernels each layer launched.

The profiler slows the host (a train takes some 1.3-1.5x as long under
it, and plain trains after it ran slower in one run on the card), so no
host time is read under it or after it.  ``mfu`` is read from the
window itself, which has no span, and ``device_idle`` sets train 3's
busy time against the window's time a train.
"""
from __future__ import annotations

import gc
import hashlib
import subprocess
import sys
import time

import torch

from portbench.harness import cells, check, inputs, program, spans, timeline
from portbench.harness import work as work_lib

#: The numbers a cell's ``workloads/<cell>.json`` sets limits for.
NUMBERS = check.NUMBERS

#: Layers by how deep their spans nest, innermost first.
NESTING = ("mix", "layer_stats", "admm")
OUTSIDE = "layer loop"


def sample_index(seed: int, trains: int) -> int:
    """Which train of the window the check compares, drawn from the seed."""
    digest = hashlib.sha256(f"portbench-check:{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") % trains


def _train_with(spec, cfg, seed, index, device, recorder, policy, profile: bool):
    """(spans, device ops or None, start_ns, end_ns) of one train with
    ``recorder``'s spans installed, under the profiler if ``profile``."""
    job = inputs.make(cfg, seed, index, device)
    marks = {}

    def one():
        marks["start"] = time.time_ns()
        program.train(spec, job)
        marks["end"] = time.time_ns()

    with spans.installed(recorder, policy):
        if profile:
            _, ops = timeline.profiled(one)
        else:
            one()
            ops = None
    return recorder.spans, ops, marks["start"], marks["end"]


def traced_phases(trace: spans.Trace, spec, seed: int, first_index: int, device):
    """Run the four traced trains; fill ``trace``; return ``breakdown``."""
    cfg = trace.config
    policy = spec.resolve_policy()
    index = iter(range(first_index, first_index + 4))

    # 1, 2. Host times, before the profiler has run in the process: the
    # layer statistics and the ADMM, then the mixes (a mix that waits
    # would slow the ADMM around it).
    for sync in (("layer_stats", "admm"), ("mix",)):
        recorded, _, _, _ = _train_with(
            spec, cfg, seed, next(index), device, spans.Recorder(sync=sync), policy,
            profile=False)
        trace.wall_spans.extend(sp for sp in recorded if sp.name in sync)

    # 3. The timeline, under spans that do not wait.
    timeline.warm_profiler()
    host, ops, start, end = _train_with(
        spec, cfg, seed, next(index), device, spans.Recorder(), policy, profile=True)
    trace.timeline_ns = end - start
    trace.busy_ns = timeline.busy_ns(ops, start, end)
    inside = [op for op in ops if start <= op[1] < end]
    breakdown = {
        "device_ops": timeline.top_ops(inside),
        "idle_gaps": timeline.label_gaps(
            timeline.idle_gaps(ops, start, end), host, NESTING, OUTSIDE),
    }
    del host, ops, inside

    # 4. Each layer's device time, every span waiting at both ends.
    recorded, ops, _, _ = _train_with(
        spec, cfg, seed, next(index), device, spans.Recorder(sync=spans.LAYERS), policy,
        profile=True)
    starts = timeline.Starts(ops)
    trace.device_spans = [
        (sp, timeline.device_ns_within(starts, sp.start_ns, sp.end_ns)) for sp in recorded]
    return breakdown


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return done.stdout.strip().splitlines()[0] if done.stdout.strip() else None


def run(cell: cells.Cell, *, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float) -> dict:
    """One run of ``cell``; ``started`` is the process's start on
    ``time.perf_counter``.  Returns the result line as a dict."""
    cfg, traffic = cell.config, cell.traffic
    on_card = device.type == "cuda"
    spec = warm_up(cell, seed, device)
    setup_s = time.perf_counter() - started

    kept, ends, index = [], [], 0
    opened = time.perf_counter()
    while True:
        kept.append(program.train(spec, inputs.make(cfg, seed, index, device)))
        ends.append(time.perf_counter())
        index += 1
        if ends[-1] - opened >= seconds:
            break
    window_s = ends[-1] - opened
    each = [b - a for a, b in zip([opened] + ends, ends)]
    print("window: trains " + " ".join(f"{s:.4f}" for s in each) + " s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = sum(not check.finite(out) for out in kept)

    result_trace = spans.Trace(
        config=cfg, window_trains=index, window_s=window_s,
        train_work=work_lib.train(cfg, exact=spec.resolve_policy().is_exact,
                                  trace_every=traffic["trace_every"]),
    )
    breakdown = None
    if trace:
        breakdown = traced_phases(result_trace, spec, seed, index, device)

    # The check, once the program's state is freed.
    sampled = sample_index(seed, index)
    out = kept[sampled]
    del kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    job = inputs.make(cfg, seed, sampled, device)
    values = check.gaps(out, reference_result(cell, job), job.r, job.x_test,
                        logits=cells.reference(cell).logits)
    within, held = check.judge(values, cell.limits)

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(result_trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"train_s": window_s / index, "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[cells.quantity(m["name"])], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace:
        dev["busy_s"] = result_trace.busy_ns / 1e9
        dev["window_s"] = result_trace.timeline_ns / 1e9
    if on_card:
        dev["power_limit"] = power_limit()
    line = {
        "correct": bool(within and failed == 0),
        "attempted": index,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    check.print_held(held, index, failed)
    line["checks"] = held
    return line


def warm_up(cell: cells.Cell, seed: int, device):
    """Set-up: the kernels, then layers 0-2 at the cell's shapes and
    policy (layer 2 is the first n -> n propagation) on a draw of their
    own, which also warms the input draw.  Returns the cell's spec."""
    spec = program.train_spec(cell.config, cell.traffic)
    if device.type == "cuda":
        program.build_kernels()
    program.train(program.shallower(spec, 2), inputs.make(cell.config, seed, -1, device))
    gc.collect()
    return spec


def reference_result(cell: cells.Cell, job: inputs.Inputs, **precision):
    """The cell's plain reference trained on ``job``: float64, or as
    ``precision`` (``dtype``, ``tf32``) sets it for the control."""
    cfg, traffic = cell.config, cell.traffic
    return cells.reference(cell).train(
        job.x_workers, job.t_workers, job.r,
        mixing_spec=traffic["mixing"], mu0=cfg["mu0"], mul=cfg["mul"],
        eps_radius=cfg["eps_scale"] * 2.0 * cfg["num_classes"],
        num_iters=cfg["admm_iters"], trace_every=traffic["trace_every"], **precision,
    )
