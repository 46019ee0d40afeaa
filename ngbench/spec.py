"""Finds a cell and everything it names, by name, from files.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics.
Beside it, under ``ngbench/``:

* ``workloads/<cell>.json``: the cell's configuration and traffic names,
  its kind, scenes, weights, engine or training settings, what its check
  compares and the limits;
* ``configs/<config>.json``: the configuration's Table-I row, with its
  ``app``;
* ``traffic/<traffic>.json``: the traffic mix's parameters, with the name
  of the generator module (``traffic/<generator>.py``) that reads them;
* ``kinds/<kind>.py``: what runs a kind of cell (``serve``,
  ``train``): set-up, window, outcome and the control's readings;
* ``apps/<app>.<kind>.py``: what one app adds to a kind: the reference's
  part, the port's kernel calls and their counted work;
* ``metrics/<metric>.py``: one per-layer metric's reader; a metric
  ``<name>.<variant>`` may share ``metrics/<name>.py`` with the other
  variants of ``<name>``.

A later cell, configuration, mix, kind, app or per-layer metric is new
files and a new entry in ``BENCHMARK.json``; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict            # the cell's entry in BENCHMARK.json
    workload: Dict
    config: Dict
    traffic: Dict

    @property
    def kind(self) -> str:
        return self.workload["kind"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(here: Path = HERE) -> Dict:
    return load_json(here.parent / "BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file of the harness, by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, here: Path = HERE) -> Cell:
    bench = benchmark(here)
    entries = {w["name"]: w for w in bench["workloads"]}
    path = here / "workloads" / f"{name}.json"
    if name not in entries and not path.is_file():
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(it has {sorted(entries)})")
    wl = load_json(path)
    # a cell with files but no entry (kept for a later PR to list) runs
    # with the entry its file implies, and reports only what names it
    entry = entries.get(name) or {"name": name, **{
        k: wl[k] for k in ("config", "traffic", "chips", "why")}}
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json names {key} "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    return Cell(name=name, entry=entry, workload=wl,
                config=load_json(here / "configs" / f"{wl['config']}.json"),
                traffic=load_json(here / "traffic" / f"{wl['traffic']}.json"))


def generator(cell: Cell, here: Path = HERE) -> ModuleType:
    gen = cell.traffic["generator"]
    return load_module(here / "traffic" / f"{gen}.py",
                       f"ngbench_traffic_{gen}")


def kind(cell: Cell, here: Path = HERE) -> ModuleType:
    """The module that runs the cell's kind, ``kinds/<kind>.py``."""
    return load_module(here / "kinds" / f"{cell.kind}.py",
                       f"ngbench_kind_{cell.kind}")


def app(cell: Cell, here: Path = HERE) -> ModuleType:
    """What the configuration's app adds to the cell's kind,
    ``apps/<app>.<kind>.py``."""
    name = f"{cell.config['app']}.{cell.kind}"
    return load_module(here / "apps" / f"{name}.py",
                       f"ngbench_app_{name.replace('.', '_')}")


def metric_file(name: str, here: Path = HERE) -> Path:
    """``metrics/<name>.py``, or for ``<base>.<variant>`` without a file
    of its own, ``metrics/<base>.py``."""
    own = here / "metrics" / f"{name}.py"
    return own if own.is_file() else \
        here / "metrics" / f"{name.split('.')[0]}.py"


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def end_to_end(cell: str, here: Path = HERE) -> List[Dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in benchmark(here)["end_to_end"]
            if _applies(m, cell, [])]


def per_layer(cell: str, here: Path = HERE) -> Dict[str, ModuleType]:
    """The per-layer metrics a cell reports: each one's reader module
    (``metric_file``), by name."""
    bench = benchmark(here)
    reported = [m["name"] for m in end_to_end(cell, here)]
    out = {}
    for m in bench["per_layer"]:
        if _applies(m, cell, reported):
            safe = m["name"].replace(".", "_").replace("-", "_")
            out[m["name"]] = load_module(metric_file(m["name"], here),
                                         f"ngbench_metric_{safe}")
    return out
