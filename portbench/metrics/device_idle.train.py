"""Share of a train's wall time in which the card runs no operation, in
%: the busy time of a profiled train (spans that do not wait) against
the window's wall time a train, which no profiler slows."""
from portbench.harness import spans


def read(trace):
    if not trace.window_trains or trace.busy_ns <= 0:
        return None
    per_train_ns = trace.window_s * 1e9 / trace.window_trains
    return 100.0 * (1.0 - trace.busy_ns / per_train_ns)


def examples():
    # 4 trains in 20 s: 5 s a train, of which the card is busy 4.
    made = spans.Trace(window_trains=4, window_s=20.0, timeline_ns=7_000_000_000,
                       busy_ns=4_000_000_000)
    return [(made, 20.0), (spans.Trace(), None)]
