"""Device ms per call of the consensus policy's ``mix``: the kernels
inside its spans, which wait for the card at both ends."""
from portbench.harness import spans, work


def read(trace):
    found = [(sp, ns) for sp, ns in trace.device_spans if sp.name == "mix"]
    if not found:
        return None
    return sum(ns for _, ns in found) / len(found) / 1e6


def examples():
    mix = spans.Span("mix", 0, 1_000_000, work.NONE)
    admm = spans.Span("admm", 0, 200_000_000, work.NONE, count=100)
    made = spans.Trace(device_spans=[(mix, 150_000), (mix, 250_000), (admm, 100_000_000)])
    return [(made, 0.2), (spans.Trace(), None)]
