"""Put the checkout and its ``src`` on the path, and give the tests a
tiny cell that a CPU run holds."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

#: A cell of every layer the benchmark measures at a size the CPU holds:
#: 4 workers of 24 samples, 3 layers after layer 0, 10 ADMM iterations.
TINY = {
    "name": "tiny", "input_dim": 12, "num_classes": 3, "num_train": 96, "num_test": 40,
    "hidden": 26, "num_layers": 3, "admm_iters": 10, "workers": 4, "mu0": 1e-3, "mul": 1.0,
    "eps_scale": 1.0, "dtype": "float32",
    "teacher": {"layers": 2, "width": 8, "label_noise": 0.05},
}
#: Limits for the tiny cell, set as the cells' are (two thirds of the way
#: from the program's worst reading to the control's least, on a log
#: scale) from CPU readings on seeds 1-3 under both policies: the program
#: reads at most 1.9e-6, 2.9e-7 and 7.0e-7, the emulated-TF32 control at
#: least 1.0e-3, 1.2e-4 and 4.9e-4.
TINY_LIMITS = {"readout_gap": 1.3e-4, "objective_gap": 1.6e-5, "logit_gap": 5.5e-5}
#: The tiny cell's traffic mixes: gossip over a ring of 4, and the mean.
TRAFFIC = {
    "gossip:6:1": {"policy": "gossip:6:1", "trace_every": 1,
                   "mixing": {"rule": "ring_gossip", "rounds": 6, "degree": 1}},
    "exact": {"policy": "exact", "trace_every": 1, "mixing": {"rule": "mean"}},
}
POLICIES = tuple(TRAFFIC)
WORKLOAD = {"driver": "dssfn_train", "reference": "dssfn_ref", "limits": TINY_LIMITS}


@pytest.fixture
def tiny_cell():
    from portbench.harness import cells

    like = cells.load("mnist-gossip")

    def make(policy: str):
        """The tiny cell, reporting the metrics of ``mnist-gossip``."""
        return cells.Cell(
            name="tiny", chips=1, config=dict(TINY), traffic=dict(TRAFFIC[policy]),
            workload=dict(WORKLOAD), end_to_end=like.end_to_end, per_layer=like.per_layer,
        )

    return make
