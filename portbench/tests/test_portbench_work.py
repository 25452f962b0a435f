"""The FLOP and byte counts against values worked by hand."""
import json
from pathlib import Path

import pytest

from portbench.harness import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_mnist_layer_statistics():
    # M=20, J_m=3000, Q=10, d = d_prev = 1020 (layers 2-20):
    # propagation 2*1020*1020*3000*20 = 124,848,000,000
    # Gram 20*1020*1021*3000 + 20*1020 = 62,485,200,000 + 20,400
    # A 2*10*1020*3000*20 = 1,224,000,000; Cholesky 20*1020^3/3 = 7,074,720,000
    got = work.layer_stats(20, 3000, 10, 1020, 1020)
    assert got.flops == 195_631_940_400
    # read: T 600,000 + W 1,040,400 + Y 61,200,000; written: Y' 61,200,000
    # + factor triangle 20*520,710 + A 20*10,200; 134,658,600 floats
    assert got.bytes == 4 * 134_658_600


def test_caltech_layer_zero_statistics():
    # M=20, J_m=300, Q=102, d=3000, no propagation:
    # Gram 20*3000*3001*300 + 20*3000 = 54,018,000,000 + 60,000
    # A 2*102*3000*300*20 = 3,672,000,000; Cholesky 20*3000^3/3 = 180,000,000,000
    got = work.layer_stats(20, 300, 102, 3000, None)
    assert got.flops == 237_690_060_000
    # read: T 612,000 + X 18,000,000; written: triangle 20*4,501,500 + A 6,120,000
    assert got.bytes == 4 * (612_000 + 18_000_000 + 90_030_000 + 6_120_000)


def test_mnist_gossip_admm_iteration():
    # untraced, per worker: 3*10,200 + 2*10*1020^2 + 3*10,200 + 2*10,200 = 20,889,600,
    # x 20 = 417,792,000; the H^B mix 2*20^2*10,200 = 8,160,000
    untraced = work.admm_iteration(20, 3000, 10, 1020, exact=False, traced=False)
    assert untraced.flops == 425_952_000
    # traced adds 20*(2*10*1020*3000 + 3*10*3000 + 3*10,200) + 3*10,200
    # + 3*20*10,200 = 1,227,054,600
    traced = work.admm_iteration(20, 3000, 10, 1020, exact=False, traced=True)
    assert traced.flops == 1_653_006_600
    # two factor triangles 20*2*520,710, six (Q, n) blocks 20*61,200, Y and T
    # 20*(3,060,000 + 30,000), the mix 2*20*10,200: 84,260,400 floats
    assert traced.bytes == 4 * 84_260_400
    # bytes bound it: 337,041,600 B at 3.35 TB/s = 0.1006 ms
    assert work.least_seconds(traced) == pytest.approx(1.006094e-4, rel=1e-6)


def test_exact_mix_is_a_sum_and_a_scale():
    assert work.mix(20, 102, 1204, exact=True).flops == 20 * 102 * 1204 + 102 * 1204
    assert work.mix(20, 102, 1204, exact=False).flops == 2 * 400 * 102 * 1204


@pytest.mark.parametrize("name,exact,tflop", [
    ("dssfn-mnist", False, 7.350540737706666),
    ("dssfn-mnist", True, 7.332767361706666),
    ("dssfn-caltech101", False, 20.16628708613333),
])
def test_whole_train(name, exact, tflop):
    # MNIST under gossip, by hand: layer 0's statistics 41,079,817,706.67
    # and 100 iterations of 1,196,953,120; layer 1's 166,745,540,400 and
    # 100 x 1,653,006,600; layers 2-20 19 x (195,631,940,400 + 100 x
    # 1,653,006,600): 7,350,540,737,706.67 in all.
    cfg = _config(name)
    got = work.train(cfg, exact=exact, trace_every=1)
    assert got.flops / 1e12 == pytest.approx(tflop, rel=1e-12)
    # 21 layer solves: layer 0, then one n <- P and nineteen n <- n
    assert work.layer_widths(cfg)[:3] == [
        (cfg["input_dim"], None), (cfg["hidden"], cfg["input_dim"]),
        (cfg["hidden"], cfg["hidden"])]
    assert len(work.layer_widths(cfg)) == 21


def test_peak_is_a_third_of_tf32():
    assert work.F32_PEAK_FLOPS == pytest.approx(165e12)
    assert work.least_seconds(work.Work(165e12, 0.0)) == pytest.approx(1.0)
    assert work.least_seconds(work.Work(0.0, 3.35e12)) == pytest.approx(1.0)
