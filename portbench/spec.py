"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

``BENCHMARK.json`` sits at the root of the checkout, the folder above this
package.  A configuration is the JSON file its entry names; a traffic mix
is ``traffic/<name>.json``; a metric is ``metrics/<name>.py``; a kind is
``kinds/<kind>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def kind(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.kinds.{name}")


def metric(name: str) -> ModuleType:
    """The reader of metric ``name``, loaded from its file (a name may
    hold dots, so it is loaded by path, not imported)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__"), path)
    if spec is None:
        raise KeyError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, group: str) -> list[dict]:
    """The entries of ``group`` (``"end_to_end"`` or ``"per_layer"``) that
    the cell reports: those with no ``workloads`` key and those that list
    it."""
    return [m for m in bench[group]
            if cell_name in m.get("workloads", [cell_name])]
