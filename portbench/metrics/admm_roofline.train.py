"""The ADMM iterations' least time (their counted work, mixes and
traces included, at the f32 peak or the HBM bandwidth) over the device
time of the kernels their spans launched, in %."""
from portbench.harness import spans, work


def read(trace):
    found = [(sp, ns) for sp, ns in trace.device_spans if sp.name == "admm"]
    device_ns = sum(ns for _, ns in found)
    if not found or device_ns <= 0:
        return None
    return 100.0 * sum(work.least_seconds(sp.work) for sp, _ in found) / (device_ns / 1e9)


def examples():
    # 3.35e11 bytes bound the work: 0.1 s at 3.35 TB/s, against 0.4 s of
    # kernels in the span.
    admm = spans.Span("admm", 0, 500_000_000, work.Work(1e9, 3.35e11), count=100)
    made = spans.Trace(device_spans=[(admm, 400_000_000)])
    return [(made, 25.0), (spans.Trace(), None)]
