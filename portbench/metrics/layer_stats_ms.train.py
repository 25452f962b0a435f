"""Wall ms per layer of the layer statistics (propagation, Gram,
Cholesky, A = T Y^T), each span waiting for the card at both ends."""
from portbench.harness import spans, work


def read(trace):
    found = [sp for sp in trace.wall_spans if sp.name == "layer_stats"]
    if not found:
        return None
    return sum(sp.end_ns - sp.start_ns for sp in found) / len(found) / 1e6


def examples():
    made = spans.Trace(wall_spans=[
        spans.Span("layer_stats", 0, 8_000_000, work.NONE),
        spans.Span("layer_stats", 10_000_000, 16_000_000, work.NONE),
        spans.Span("admm", 0, 200_000_000, work.NONE, count=100)])
    return [(made, 7.0), (spans.Trace(), None)]
