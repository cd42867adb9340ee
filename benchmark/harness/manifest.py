"""The manifest (``BENCHMARK.json``) and the files it names.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json`` (the entry's
``file``), ``traffic/<traffic>.json`` and ``limits/<cell>.json``; the
mix's ``kind`` is driven and checked by ``kinds/<kind>.py``; a metric
``<name>`` is read by ``metrics/<name>.py``; a kernel's operations and
bytes come from ``counts/<kernel>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell`` (its ``workloads`` key,
    or every cell without one)."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, manifest_path: str = MANIFEST) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic,
    limits and metrics."""
    m = load_json(manifest_path)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {manifest_path}: {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in m["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=load_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic=load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
        end_to_end=[e for e in m["end_to_end"] if reports(e, name)],
        per_layer=[e for e in m["per_layer"] if reports(e, name)])


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, as a module (a name may
    hold dots, so it is loaded by path)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
