"""The layer statistics' least time (their counted work at the f32 peak
or the HBM bandwidth) over the device time of the kernels their spans
launched, in %."""
from portbench.harness import spans, work


def read(trace):
    found = [(sp, ns) for sp, ns in trace.device_spans if sp.name == "layer_stats"]
    device_ns = sum(ns for _, ns in found)
    if not found or device_ns <= 0:
        return None
    return 100.0 * sum(work.least_seconds(sp.work) for sp, _ in found) / (device_ns / 1e9)


def examples():
    # 1.65e9 FLOPs bound the work: 10 us at 165 TFLOP/s, against 4 ms of
    # kernels in the span; the mix span's kernels are not counted.
    stats = spans.Span("layer_stats", 0, 8_000_000, work.Work(1.65e9, 3.35e3))
    mix = spans.Span("mix", 0, 1_000_000, work.Work(1e12, 0.0))
    made = spans.Trace(device_spans=[(stats, 4_000_000), (mix, 150_000)])
    return [(made, 0.25), (spans.Trace(), None)]
