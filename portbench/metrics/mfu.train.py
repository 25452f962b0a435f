"""The window's counted FLOPs (every layer's statistics and ADMM
iterations, traces included) over its wall time and the f32 peak
(a third of the published TF32 rate), in %."""
from portbench.harness import spans, work


def read(trace):
    if not trace.window_trains or trace.window_s <= 0:
        return None
    flops = trace.train_work.flops * trace.window_trains
    return 100.0 * flops / trace.window_s / work.F32_PEAK_FLOPS


def examples():
    # 4 trains of 8.25 TFLOP in 20 s: 1.65 TFLOP/s, 1% of 165.
    made = spans.Trace(window_trains=4, window_s=20.0, train_work=work.Work(8.25e12, 1e9))
    return [(made, 1.0), (spans.Trace(), None)]
