"""The manifest against the contract's limits on names, units and keys,
and every file it names found by name."""

import json
import os
import re

import pytest

from harness.manifest import BENCH_DIR, MANIFEST, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert os.path.getsize(MANIFEST) <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in manifest["paths"])
    assert len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    cells = []
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in manifest["workloads"]}) == len(cells)
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))


def test_every_cell_reports(manifest):
    for w in manifest["workloads"]:
        def has(kind):
            return [m for m in manifest[kind] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(has("end_to_end")) >= 2 and has("per_layer")


def test_files_found_by_name(manifest):
    for w in manifest["workloads"]:
        assert os.path.isfile(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(BENCH_DIR, "limits", w["name"] + ".json"))
    for m in manifest["per_layer"] + manifest["end_to_end"]:
        if m["name"] != "setup_s":
            assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", m["name"] + ".py"))


def test_paths_hold_only_names(manifest):
    for p in manifest["paths"]:
        for dirpath, dirnames, files in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
