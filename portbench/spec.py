"""Find a cell's parts by name: ``BENCHMARK.json`` at the checkout's root,
and under ``portbench/`` one file per configuration (``configs/<name>.json``),
traffic mix (``traffic/<name>.json``), cell's limits (``limits/<cell>.json``), per-layer metric
(``metrics/<name>.py``, which names the program callables it needs wrapped
in profiler scopes), model kind (``models/<kind>.py``, named by a
configuration's ``"model"``) and the faults of a model kind's calls
(``faults/<kind>.py``).

Nothing here lists them: a cell, configuration, mix or metric is added by
adding its files and its ``BENCHMARK.json`` entry.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def benchmark(root: Path = CHECKOUT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "configs" / f"{name}.json").read_text())


def traffic(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def limits(name: str, base: Path = HERE) -> Dict[str, float]:
    """The limit of each number a cell's check compares, ``limits/<cell>.json``."""
    return json.loads((base / "limits" / f"{name}.json").read_text())["limits"]


def model(kind: str) -> ModuleType:
    """The adapter of a model kind, ``portbench.models.<kind>``."""
    return importlib.import_module(f"portbench.models.{kind}")


def metric_reader(name: str, base: Path = HERE) -> ModuleType:
    """The reader of a per-layer metric, ``metrics/<name>.py``; its ``read``
    takes a ``portbench.trace.Trace`` and returns a number or ``None``."""
    path = base / "metrics" / f"{name}.py"
    mod_name = "portbench.metrics._" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def spans(readers) -> Dict[str, str]:
    """Span name -> the program's callable it wraps (``"module:Class.method"``),
    as the metric readers ``readers`` name them in their ``SPANS``."""
    out: Dict[str, str] = {}
    for reader in readers:
        for name, target in getattr(reader, "SPANS", {}).items():
            if out.setdefault(name, target) != target:
                raise ValueError(f"span {name!r} names both {out[name]} and {target}")
    return out


def cell_metrics(bench: dict, cell: dict, section: str) -> List[dict]:
    """The metrics of ``section`` (``"end_to_end"`` or ``"per_layer"``) that
    ``cell`` reports: those whose ``workloads`` name it, and those without
    the key that move an end-to-end metric the cell reports (per-layer) or
    that every cell reports (end-to-end)."""
    name = cell["name"]
    if section == "end_to_end":
        return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]
