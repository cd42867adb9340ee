"""The reader ``copy_out_pinned_share.extract``: None where the port keeps
no ``to_host`` counter (a program from before it) or the run is not an
extraction; 100 where every step's outputs came back through pinned
memory; and a tiny traced extraction on the CPU, which stages nothing
through pinned memory, reads 0 from the port's own counter."""

import time
from types import SimpleNamespace

import pytest

from bench_tiny import tiny_cell, write_scene
from harness.cells import run_cell
from harness.manifest import load_cell, load_module

SEED = 2 ** 31 + 2323
NAME = "copy_out_pinned_share.extract"
KEY = "transfer.to_host.launches"


@pytest.mark.parametrize("kind, counters, steps, want", [
    ("extract", {}, [8, 8, 8], None),  # no such counter: the parent reads None
    ("extract", {KEY: 3}, [8, 8, 8], 100.0),
    ("extract", {KEY: 3}, [8, 8, 8, 8], 75.0),  # a step retried in a larger bucket
    ("extract", {KEY: 0}, [], None),
    ("train", {KEY: 0}, [8], None),
])
def test_reader(kind, counters, steps, want):
    run = SimpleNamespace(kind=kind, counters=counters, step_rows=steps)
    assert load_module("metrics", NAME).read(run) == want


def test_traced_run_reads_the_counter(tmp_path):
    cell = tiny_cell("extract", write_scene(tmp_path / "scene_0.npz"))
    cell.per_layer = [m for m in load_cell("d3feat-3dmatch.extract-b8").per_layer
                      if m["name"] == NAME]
    out = run_cell(cell, SEED, 0.5, True, time.time(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"][NAME]["value"] == 0.0
