"""Wall ms per call of the consensus policy's ``mix``, each span waiting
for the card at both ends."""
from portbench.harness import spans, work


def read(trace):
    found = [sp for sp in trace.wall_spans if sp.name == "mix"]
    if not found:
        return None
    return sum(sp.end_ns - sp.start_ns for sp in found) / len(found) / 1e6


def examples():
    made = spans.Trace(wall_spans=[
        spans.Span("mix", 0, 1_000_000, work.NONE),
        spans.Span("mix", 2_000_000, 4_000_000, work.NONE),
        spans.Span("admm", 0, 200_000_000, work.NONE, count=100)])
    return [(made, 1.5), (spans.Trace(), None)]
