"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cell's configuration and traffic mix and the
metrics; everything else is a file under this folder:

- ``configs/<config>.json``: the deployment (suite, catalog, scale
  factor, batch size, node and session settings);
- ``traffic/<mix>.json``: the loop, its clients and the templates'
  weights;
- ``queries/<suite>/<template>.sql`` and ``.json``: a template and its
  parameter rule;
- ``reference/<suite>/tables.py`` and ``reference/<suite>/<template>.py``:
  the plain reference;
- ``metrics/<metric>.py``: the reader of one metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional

#: the folder of the benchmark (``gpubench/``)
HERE = pathlib.Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str                     # "end_to_end" or "per_layer"
    entry: Dict


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    metrics: List[Metric]


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """A module from its file, under a name that cannot clash with an
    installed package (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: Dict, cell: str, by_name: Dict[str, Dict]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:             # an end-to-end metric of every cell
        return True
    return _reports(by_name[moves], cell, by_name)


def load_cell(root: pathlib.Path, workload: str,
              bench: Optional[Dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    metrics = [Metric(m["name"], m["unit"], "end_to_end", m)
               for m in bench["end_to_end"] if _reports(m, workload, e2e)]
    metrics += [Metric(m["name"], m["unit"], "per_layer", m)
                for m in bench["per_layer"] if _reports(m, workload, e2e)]
    return Cell(workload, int(w["chips"]), config, traffic, metrics)


def template(suite: str, name: str):
    """(SQL text, parameter rule) of one template."""
    base = HERE / "queries" / suite
    return ((base / f"{name}.sql").read_text(),
            json.loads((base / f"{name}.json").read_text()))


def reference(suite: str, name: str) -> ModuleType:
    return importlib.import_module(f"gpubench.reference.{suite}.{name}")


def reference_tables(suite: str) -> ModuleType:
    return importlib.import_module(f"gpubench.reference.{suite}.tables")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"gpubench_metric_{name.replace('.', '_')}")
