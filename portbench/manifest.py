"""`BENCHMARK.json` and the files the harness finds by name.

Every configuration, traffic mix, driver, metric reader and limit file is
looked up by the name that `BENCHMARK.json` (or a configuration file)
gives it, so a later cell or metric is added by adding files, never by
editing one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

#: this package's folder, and the checkout's root beside it
PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

#: a name: a letter, digit or `_` first, then at most 63 letters, digits,
#: `_`, `.` and `-`
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
#: a unit: 1 to 16 letters, digits, `_`, `/`, `%`, `.` and `-`
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

END_TO_END, PER_LAYER = "end_to_end", "per_layer"


def _name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"{name!r} is not a valid name")
    return name


def load(root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in manifest['workloads']]}")


def applies(metric: Dict[str, Any], cell_name: str) -> bool:
    """Whether a metric is reported in a cell: in every cell unless it
    lists its cells under `workloads`."""
    return cell_name in metric.get("workloads", [cell_name])


def metrics_for(manifest: Dict[str, Any], cell_name: str,
                traced: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics (untraced run) or its per-layer
    metrics (traced run), in manifest order."""
    kind = PER_LAYER if traced else END_TO_END
    return [m for m in manifest[kind] if applies(m, cell_name)]


def _json(folder: str, name: str) -> Dict[str, Any]:
    return json.loads((PKG / folder / f"{_name(name)}.json").read_text())


def config(name: str) -> Dict[str, Any]:
    """`configs/<name>.json`, with the folder it lies in under `dir`."""
    doc = _json("configs", name)
    doc["dir"] = str(PKG / "configs")
    return doc


def traffic(name: str) -> Dict[str, Any]:
    return _json("traffic", name)


def limits(cell_name: str) -> Dict[str, float]:
    """Each compared number's limit in a cell (`limits/<cell>.json`)."""
    return {k: float(v["limit"]) for k, v in
            _json("limits", cell_name)["limits"].items()}


def load_module(path: Path) -> ModuleType:
    """Import a file by path; its module name is made from the path, as a
    metric's name may hold dots."""
    mod_name = "portbench._by_path." + re.sub(r"\W", "_", str(
        path.relative_to(PKG)))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str) -> ModuleType:
    return load_module(PKG / "drivers" / f"{_name(name)}.py")


def reader(metric_name: str) -> ModuleType:
    return load_module(PKG / "metrics" / f"{_name(metric_name)}.py")
