"""The harness against its contract: ``BENCHMARK.json``, the files it
names, the result line, and what a run may load."""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.drivers import dssfn_train
from portbench.harness import cells
from portbench.reference import mixing

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_benchmark_keys_names_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cell_names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    """Every file a cell names is there and is what the harness expects:
    its driver, its reference and the reference's mixing rule load by
    name, its file sets a limit for each number its driver compares, and
    it reports setup_s, another end-to-end metric and a per-layer one."""
    cell = cells.load(workload)
    driver = cells.driver(cell)
    assert callable(driver.run) and set(cell.limits) == set(driver.NUMBERS)
    assert callable(cells.reference(cell).train)
    assert isinstance(cell.traffic["policy"], str)
    assert callable(mixing.make(cell.traffic["mixing"], cell.config["workers"],
                                device="cpu", dtype=torch.float64))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert {m["moves"] for m in cell.per_layer} <= reported


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_gives_its_worked_examples(metric):
    """Each reader against the examples worked by hand in its own file,
    one of them a trace with nothing to read, where it gives None."""
    module = cells.metric_module(metric)
    examples = module.examples()
    assert any(want is None for _, want in examples)
    assert any(want is not None for _, want in examples)
    for trace, want in examples:
        got = module.read(trace)
        assert (got is None) if want is None else got == pytest.approx(want)


def test_a_cell_reports_the_metrics_of_its_group(tmp_path):
    """An end-to-end metric split by groups of cells reads its quantity;
    a per-layer metric goes to the cells that report what it moves."""
    made = dict(BENCH)
    made["end_to_end"] = [
        {"name": "setup_s"}, {"name": "train_s", "workloads": ["mnist-gossip"]},
        {"name": "train_s.other", "workloads": ["mnist-exact"]}]
    made["per_layer"] = [
        {"name": "a", "moves": "train_s"}, {"name": "b", "moves": "train_s.other"},
        {"name": "c", "moves": "train_s", "workloads": ["caltech-gossip"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(made))
    cell = cells.load("mnist-gossip", path)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_s"]
    assert [m["name"] for m in cell.per_layer] == ["a"]
    assert [m["name"] for m in cells.load("mnist-exact", path).per_layer] == ["b"]
    assert [cells.quantity(m["name"]) for m in made["end_to_end"]] == [
        "setup_s", "train_s", "train_s"]


def test_result_line(tiny_cell):
    line = dssfn_train.run(tiny_cell("gossip:6:1"), seed=2**33 + 5, seconds=0.2, trace=False,
                      device=torch.device("cpu"), started=time.perf_counter())
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(line)


def _run(code: str, *args, **kw):
    return subprocess.run([sys.executable, *args] if not code else [sys.executable, "-c", code],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, **kw)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    done = _run("", "portbench/run.py", "--workload", "mnist-gossip", "--seed",
                str(2**31 + 3), "--seconds", "1")
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "needs 1 CUDA device" in done.stderr


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    code = f"""
import sys, time, json
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import torch
from conftest import TINY, TRAFFIC, WORKLOAD
from portbench import calibrate, run
from portbench.harness import cells, faults
b = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for m in b["per_layer"]:
    cells.metric_module(m["name"]).examples()
like = cells.load("mnist-gossip")
cell = cells.Cell("tiny", 1, TINY, TRAFFIC["gossip:6:1"], WORKLOAD, like.end_to_end,
                  like.per_layer)
cells.driver(cell).run(cell, seed=9, seconds=0.1, trace=False, device=torch.device("cpu"),
           started=time.perf_counter())
print(json.dumps(run.forbidden_modules()))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    done = _run(code)
    assert done.returncode == 0, done.stderr[-3000:]
    flagged, tops = (json.loads(x) for x in done.stdout.strip().splitlines()[-2:])
    assert flagged == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert "repro_torch" in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = _run("", "portbench/run.py", "--workload", "mnist-gossip", "--seed",
                str(2**31 + 99), "--seconds", "1", "--trace", "1")
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {m["name"] for m in cells.load("mnist-gossip").per_layer} == set(line["metrics"])
    for name in ("mfu.train", "layer_stats_roofline.train", "admm_roofline.train"):
        assert 0 < line["metrics"][name]["value"] <= 100
