"""The reader ``neighbor_max_kernel_share.extract``: None where the port
keeps no ``neighbor_max`` counters (a program from before K7), where the
window took no neighbourhood max or the run is not an extraction; 100 where
K7 took every one, 50 where the twin took half; and a tiny traced
extraction on the CPU, which takes every one by the twin, reads 0 from the
port's own counters."""

import time
from types import SimpleNamespace

import pytest

from bench_tiny import tiny_cell, write_scene
from harness.cells import run_cell
from harness.manifest import load_cell, load_module

SEED = 2 ** 31 + 2525
NAME = "neighbor_max_kernel_share.extract"
K, F = "neighbor_max.neighbor_max.launches", "neighbor_max.neighbor_max.launches_fallback"


@pytest.mark.parametrize("kind, counters, want", [
    ("extract", {}, None),  # no such counters: the parent reads None
    ("extract", {K: 0, F: 0}, None),  # no neighbourhood max in the window
    ("extract", {K: 500, F: 0}, 100.0),
    ("extract", {K: 250, F: 250}, 50.0),
    ("train", {K: 0, F: 40}, None),
])
def test_reader(kind, counters, want):
    run = SimpleNamespace(kind=kind, counters=counters)
    assert load_module("metrics", NAME).read(run) == want


def test_traced_run_reads_the_counters(tmp_path):
    cell = tiny_cell("extract", write_scene(tmp_path / "scene_0.npz"))
    cell.per_layer = [m for m in load_cell("d3feat-3dmatch.extract-b8").per_layer
                      if m["name"] == NAME]
    out = run_cell(cell, SEED, 0.5, True, time.time(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 0.0
