"""A cell of ``BENCHMARK.json``, and the files that define it, by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: the configuration's sizes;
- ``traffic/<traffic>.json``: the program's consensus policy
  (``"policy"``), the reference's rule for it (``"mixing"``, a module of
  :mod:`portbench.reference.mixing`) and the trace stride;
- ``workloads/<cell>.json``: the driver that runs the cell
  (``drivers/<driver>.py``), the plain reference it is held to
  (``reference/<reference>.py``) and the limits that decide ``correct``;
- ``metrics/<metric>.py``: a reader with ``read(trace) -> float | None``
  and ``examples()``, its worked examples as ``(trace, value)`` pairs.

An end-to-end metric is named by its quantity (``train_s``), then, where
cells hold it to bounds of their own, a dot and the name of their group
(``train_s.caltech``).  A per-layer metric with no ``workloads`` key is
reported in every cell that reports the end-to-end metric it moves.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: ``workloads/<cell>.json``: ``driver``, ``reference``, ``limits``.
    workload: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def quantity(metric: str) -> str:
    """What an end-to-end metric measures: its name up to the first dot."""
    return metric.split(".")[0]


def load(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``benchmark`` with its files read."""
    bench = _load_json(benchmark)
    matches = [w for w in bench["workloads"] if w["name"] == name]
    if not matches:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"no workload {name!r} in {benchmark} (known: {known})")
    entry = matches[0]
    end_to_end = [m for m in bench["end_to_end"] if _listed(m, name)]
    reported = {m["name"] for m in end_to_end}
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_load_json(PORTBENCH / "configs" / f"{entry['config']}.json"),
        traffic=_load_json(PORTBENCH / "traffic" / f"{entry['traffic']}.json"),
        workload=_load_json(PORTBENCH / "workloads" / f"{name}.json"),
        end_to_end=end_to_end,
        per_layer=[m for m in bench["per_layer"]
                   if m["moves"] in reported and _listed(m, name)],
    )


def driver(cell: Cell):
    """The module ``drivers/<driver>.py`` that runs ``cell``: its
    ``run(cell, *, seed, seconds, trace, device, started)`` returns the
    result line, and its ``NUMBERS`` name the limits a cell sets."""
    return importlib.import_module(f"portbench.drivers.{cell.workload['driver']}")


def reference(cell: Cell):
    """The plain reference ``reference/<reference>.py`` of ``cell``."""
    return importlib.import_module(f"portbench.reference.{cell.workload['reference']}")


def metric_module(metric: str):
    """The module ``metrics/<metric>.py``: ``read`` and ``examples``."""
    path = PORTBENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return metric_module(metric).read
