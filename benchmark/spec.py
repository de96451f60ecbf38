"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the root
of the checkout names each cell, configuration, traffic mix and metric;
each has a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by
  ``traffic/generator.py``;
- ``workloads/<cell>.json``: the cell's correctness limits and the
  readings they were set from;
- ``entries/<entry>.py``: the configuration's ``entry`` (its file's key):
  the system under test, its plain reference and its counted work;
- ``metrics/<metric>.py``: a reader ``read(rec)`` of one metric from the
  run's records (``run.py`` documents them), returning None where it
  finds nothing to read.

A later change adds a configuration, a cell or a metric by adding files and
entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(BENCH / "configs" / f"{name}.json")


def entry(name: str) -> ModuleType:
    """``entries/<name>.py``, the entry a configuration names."""
    return importlib.import_module(f"benchmark.entries.{name}")


def limits(cell: str) -> Dict[str, float]:
    return load_json(BENCH / "workloads" / f"{cell}.json")["limits"]


def metrics_of(spec: Dict[str, Any], cell: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    trace, the per-layer ones with it; each only where its ``workloads``
    (if given) name the cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str) -> Callable[[Dict[str, Any]], Any]:
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
