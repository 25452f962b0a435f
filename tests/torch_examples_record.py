"""The stdout of ``repro``'s six ``examples/*.py`` scripts, stored once, and
the helpers the tests of their twins in ``examples/torch_port/`` share.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_examples_record.py [script ...]

runs each named script (all six without arguments) in a subprocess on the
CPU, as ``PYTHONPATH=src python examples/<script>.py`` with ``ARGS``, and
writes its stdout verbatim under ``tests/data/torch_examples_repro/
<script>.txt`` below one header line that names the command and the
``jax`` version.  Running all six live beside the twins would cost the
test run minutes, so the tests read these files and one of them
(``test_torch_examples_record.py``) re-runs the cheapest script live to
show that the file is still what ``repro`` prints.

A printed number is held to a full-precision value within its bar plus
half a unit of its last printed digit (:func:`held`); wall times and
rates are skipped, and :func:`skeleton` (the text with every number
replaced by ``#``) holds the format.  Where the printed digits are
coarser than the bar, the print limits the check: quickstart's costs
(0.1, up to 1.6e-3 of a cost), layerwise_readout's costs (0.01; the
deeper taps print 0.00 and 0.02) and robust_networks' two significant
digits, whose five lines far below the 1e-4 bar are also held within a
factor of ``BARS["robust_ratio"]``.
"""
from __future__ import annotations

import importlib.metadata
import importlib.util
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "torch_examples_repro")
TWINS = os.path.join(ROOT, "examples", "torch_port")

#: Each script and the arguments it is recorded with (``train_lm`` cut to
#: a size a CPU test can carry ``repro``'s 99M weights through).
ARGS = {
    "quickstart": [],
    "gossip_vs_spectral_gap": [],
    "robust_networks": [],
    "layerwise_readout": [],
    "serve_decode": [],
    "train_lm": ["--steps", "2", "--batch", "1", "--seq", "32"],
}

NUMBER = re.compile(r"[-+]?\d+(?:,\d{3})*(?:\.\d+)?(?:[eE][-+]?\d+)?")


def run_repro(name: str, timeout_s: float = 600.0) -> str:
    """``repro``'s script ``name`` run on the CPU; its stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, os.path.join("examples", f"{name}.py"), *ARGS[name]]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout_s, check=False)
    if proc.returncode:
        raise RuntimeError(f"examples/{name}.py exited {proc.returncode}:\n{proc.stderr}")
    return proc.stdout


def header(name: str) -> str:
    args = " ".join(["python", f"examples/{name}.py", *ARGS[name]])
    return f"# {args} (JAX_PLATFORMS=cpu), jax {importlib.metadata.version('jax')}"


def record(names) -> None:
    os.makedirs(DATA, exist_ok=True)
    for name in names:
        out = run_repro(name)
        with open(os.path.join(DATA, f"{name}.txt"), "w") as f:
            f.write(header(name) + "\n" + out)
        print(f"recorded {name}: {len(out.splitlines())} lines")


def stored(name: str) -> list[str]:
    """The stored stdout of ``repro``'s ``name``, header dropped, as lines."""
    with open(os.path.join(DATA, f"{name}.txt")) as f:
        lines = f.read().splitlines()
    if not lines or not lines[0].startswith("# "):
        raise ValueError(f"{name}.txt has no header line")
    return lines[1:]


def skeleton(lines) -> list[str]:
    """Each line with every number replaced by ``#``: the format alone."""
    return [NUMBER.sub("#", line) for line in lines]


def numbers(line: str) -> list[str]:
    """The printed numbers of ``line``, as printed."""
    return NUMBER.findall(line)


def half_unit(token: str) -> float:
    """Half a unit of the last printed digit of ``token`` ("0.873" ->
    5e-4, "2.5e-03" -> 5e-5, "1,234" -> 0.5)."""
    mant, _, exp = token.replace(",", "").lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 0.5 * 10.0 ** (int(exp or 0) - decimals)


def value(token: str) -> float:
    return float(token.replace(",", ""))


def held(token: str, got: float, bar: float) -> bool:
    """``got`` is within ``bar`` (absolute) plus half a unit of the last
    printed digit of the stored ``token``."""
    return abs(got - value(token)) <= bar + half_unit(token)


def load_twin(name: str):
    """The twin ``examples/torch_port/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"torch_port_{name}", os.path.join(TWINS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: The bars the printed numbers are held to: those the port's tests hold
#: the same functions to.  Spectral gaps, B, B*, eq.-15 scalars, parameter
#: counts, train accuracies and the served stack's accuracy and counts
#: are exact; quickstart's accuracies and agreement may flip one test
#: sample.
BARS = {
    "cost_rel": 1e-4,        # quickstart's and layerwise_readout's costs
    "gossip_rel": 1e-6,      # gossip errors, x err0 (the script's noise floor)
    "robust_abs": 1e-4,      # robust_networks' relative errors (o_star's bar)
    "robust_ratio": 10.0,    # ... and each within this factor of the stored value
    "gap_abs": 1e-4,         # layerwise_readout's M=4 gap
    "loss_rel": (1e-5, 1e-4),  # train_lm's step-0 and step-1 losses
}


class Checks:
    """Each stored number against the twin's value, as records
    ``{"what", "stored", "got", "bar", "ok"}``."""

    def __init__(self):
        self.records: list[dict] = []

    def number(self, what: str, token: str, got: float, bar: float = 0.0) -> None:
        of_bar = abs(float(got) - value(token)) / (bar + half_unit(token))
        self.records.append({"what": what, "stored": token, "got": float(got), "bar": bar,
                             "ok": held(token, got, bar), "of_bar": of_bar})

    def ratio(self, what: str, token: str, got: float, factor: float) -> None:
        """``got`` within a factor ``factor`` of the stored value (both
        positive): for numbers far below an absolute bar."""
        want, got = value(token), float(got)
        of_bar = (abs(math.log(got / want)) / math.log(factor)
                  if got > 0 < want else math.inf)
        self.records.append({"what": f"{what} (x{factor:g})", "stored": token, "got": got,
                             "bar": factor, "ok": of_bar <= 1.0, "of_bar": of_bar})

    def count(self, what: str, token: str, got: int) -> None:
        self.records.append({"what": what, "stored": token, "got": got, "bar": 0,
                             "ok": value(token) == got})

    def format(self, what: str, printed, want) -> None:
        self.records.append({"what": f"{what} format", "stored": len(want), "got": len(printed),
                             "bar": 0, "ok": skeleton(printed) == skeleton(want)})

    def failed(self) -> list[dict]:
        return [r for r in self.records if not r["ok"]]

    def worst(self) -> float:
        """The largest distance over its bar over the numbers: |got - stored|
        / (bar + half a unit), or for a ratio |ln(got / stored)| / ln(factor)."""
        return max((r["of_bar"] for r in self.records if "of_bar" in r), default=0.0)


def check_quickstart(c: Checks, out: dict, printed) -> None:
    want = stored("quickstart")
    c.format("quickstart", printed, want)
    lines = [numbers(line) for line in want]
    gap, rounds = lines[0][2:]   # "M=8 d=2: spectral gap G, gossip rounds B=R"
    c.number("spectral gap", gap, out["spectral_gap"])
    c.count("gossip rounds", rounds, out["rounds"])
    costs = lines[1][1:]         # after the wall time
    c.count("layers", str(len(costs)), len(out["layer_costs"]))
    for i, (token, cost) in enumerate(zip(costs, out["layer_costs"])):
        c.number(f"layer {i} cost", token, cost, BARS["cost_rel"] * abs(cost))
    c.count("eq.-15 scalars", lines[2][0], out["comm_scalars"])
    flip = 1.0 / out["num_test"]
    for token, key in zip(lines[3], ("acc_c", "acc_d", "agreement")):
        c.number(key, token, out[key], flip)


def check_gossip_vs_spectral_gap(c: Checks, out: dict, printed) -> None:
    want = stored("gossip_vs_spectral_gap")
    c.format("gossip_vs_spectral_gap", printed, want)
    floor = BARS["gossip_rel"] * out["err0"]
    lines = [numbers(line) for line in want]
    lines = [line for line in lines if line]
    for sweep in out["sweeps"]:
        n = len(sweep["errs"])
        head, _, *rows = lines[:2 + n]
        lines = lines[2 + n:]
        name = sweep["topology"]
        gap, _, lam2, edges = head[-4:]   # "gap G (lambda_2 = L, E edges/node)"
        c.number(f"{name} spectral gap", gap, sweep["gap"])
        c.number(f"{name} lambda_2", lam2, sweep["lam2"])
        c.count(f"{name} edges", edges, sweep["edges"])
        for b, (row, err, pred) in enumerate(zip(rows, sweep["errs"], sweep["predicted"]), 1):
            c.count(f"{name} B", row[0], b)
            c.number(f"{name} B={b} err", row[1], err, floor)
            c.number(f"{name} B={b} lambda_2^B err0", row[2], pred, floor)
    star = lines[0]   # "...: B* = B rounds for tol T: measured err E (err0 E0)"
    c.count("B*", star[1], out["b_star"])
    c.number("B* err", star[-3], out["err_star"], floor)
    c.number("err0", star[-1], out["err0"], floor)


def check_robust_networks(c: Checks, out: dict, printed) -> None:
    want = stored("robust_networks")
    c.format("robust_networks", printed, want)
    errs = [numbers(line)[-1] for line in want[2:]]   # after the heading and a blank line
    c.count("solves", str(len(errs)), len(out["rel_err"]))
    for token, (key, err) in zip(errs, out["rel_err"].items()):
        c.number(f"{key} rel err", token, err, BARS["robust_abs"])
        c.ratio(f"{key} rel err", token, err, BARS["robust_ratio"])


def check_layerwise_readout(c: Checks, out: dict, printed) -> None:
    want = stored("layerwise_readout")
    c.format("layerwise_readout", printed, want)
    lines = [numbers(line) for line in want]
    taps = lines[1:-1]
    c.count("taps", str(len(taps)), len(out["costs"]))
    for (tap, cost, acc), got_c, got_a in zip(taps, out["costs"], out["train_acc"]):
        c.number(f"tap {tap} cost", cost, got_c, BARS["cost_rel"] * abs(got_c))
        c.number(f"tap {tap} train-acc", acc, got_a)
    c.number("M=4 gap", lines[-1][-1], out["gap"], BARS["gap_abs"])


def check_serve_dssfn(c: Checks, out: dict, printed) -> None:
    """The dSSFN line of ``serve_decode`` (the zoo lines print times, and
    the engine's description names the port's device and dtype)."""
    want = stored("serve_decode")[-1:]
    c.format("serve_decode dssfn", printed[-1:], want)
    requests, lowerings, batches, acc = numbers(want[0])
    c.count("requests", requests, out["requests"])
    c.count("lowerings", lowerings, out["lowerings"])
    c.count("batches", batches, out["batches"])
    c.number("served acc", acc, out["acc"])


def check_train_lm(c: Checks, out: dict, printed) -> None:
    want = stored("train_lm")
    c.format("train_lm", printed, want)
    lines = [numbers(line) for line in want]
    c.number("params (M)", lines[0][0], out["params"] / 1e6)
    rels = BARS["loss_rel"]
    for (step, loss), got, rel in zip(lines[1:3], out["losses"], rels):
        c.number(f"step {step} loss", loss, got, rel * abs(got))
    first, last = lines[3]
    c.number("first loss", first, out["losses"][0], rels[0] * abs(out["losses"][0]))
    c.number("last loss", last, out["losses"][-1], rels[-1] * abs(out["losses"][-1]))


if __name__ == "__main__":
    record(sys.argv[1:] or list(ARGS))
