"""Wall ms per ADMM iteration, mixes included: the spans around the K
iterations of every layer, each waiting for the card at both ends,
over the iterations they ran."""
from portbench.harness import spans, work


def read(trace):
    found = [sp for sp in trace.wall_spans if sp.name == "admm"]
    iterations = sum(sp.count for sp in found)
    if not iterations:
        return None
    return sum(sp.end_ns - sp.start_ns for sp in found) / iterations / 1e6


def examples():
    # Two layers of 100 iterations, 200 and 300 ms: 500 ms / 200; a mix
    # span nested inside is not counted again.
    made = spans.Trace(wall_spans=[
        spans.Span("admm", 0, 200_000_000, work.NONE, count=100),
        spans.Span("admm", 0, 300_000_000, work.NONE, count=100),
        spans.Span("mix", 0, 1_000_000, work.NONE)])
    return [(made, 2.5), (spans.Trace(), None)]
