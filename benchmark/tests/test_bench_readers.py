"""The end-to-end readers read what the run holds in every cell the manifest
lists for them, with no test of the run's kind, and the KPFCNN walk behind
``run.forward_ops`` runs when a reader calls it: on the same runs of the
tiny extraction and train cells, every metric of the three cells reads the
same value, to the last bit, as through the readers that tested the kind
and the walk made before any reader ran."""

import time

import numpy as np
import pytest

from bench_tiny import tiny_cell, write_scene
from harness import cells
from harness.cells import run_cell
from harness.manifest import load_cell, load_module
from reference import model as ref_model

SEED = 2 ** 31 + 5151
CELLS = {"extract": ("d3feat-3dmatch.extract-b8", "d3feat-3dmatch-deform.extract-b8"),
         "train": ("d3feat-3dmatch.train-pair",)}


def _old_fragments_per_s(run):
    if run.kind != "extract" or not run.window_s:
        return None
    return run.done / run.window_s


def _old_group_p95_ms(run):
    if run.kind != "extract" or not run.lat:
        return None
    return 1000.0 * float(np.percentile(run.lat, 95))


def _old_steps_per_s(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.done / run.window_s


OLD = {"extract_fragments_per_s": _old_fragments_per_s,
       "extract_group_p95_ms": _old_group_p95_ms, "train_steps_per_s": _old_steps_per_s}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene") / "scene_0.npz")


@pytest.fixture
def runs(monkeypatch):
    """Every ``run`` handed to a reader, with the reader's name."""
    seen = []
    real = cells.load_module

    def load(what, name):
        mod = real(what, name)
        if what != "metrics":
            return mod

        class Reader:
            @staticmethod
            def read(run):
                seen.append((name, run))
                return mod.read(run)
        return Reader

    monkeypatch.setattr(cells, "load_module", load)
    return seen


@pytest.mark.parametrize("kind", ["extract", "train"])
@pytest.mark.parametrize("traced", [False, True])
def test_same_readings(scene, runs, kind, traced):
    cell = tiny_cell(kind, scene)
    real = load_cell(CELLS[kind][0])
    cell.end_to_end, cell.per_layer = real.end_to_end, real.per_layer
    out = run_cell(cell, SEED, 0.5, traced, time.time(), device="cpu")
    assert out["correct"], out["checks"]
    assert runs
    walk = ref_model.blocks(cell.config, cells.architecture(cell.config))[:2]
    count = load_module("counts", "kpfcnn")
    for name, run in runs:
        new = load_module("metrics", name).read(run)
        if name in OLD:
            assert new == OLD[name](run) and new is not None, name
        for c in run.pyramid_counts:
            assert run.forward_ops(c) == count.forward_ops(
                walk, c, cell.config["num_kernel_points"], cell.config["output_dim"])
    wanted = {m["name"] for m in (real.per_layer if traced else real.end_to_end)} - {"setup_s"}
    assert {name for name, _ in runs} == wanted


def test_every_cell_listed():
    """Each existing cell reads its end-to-end metrics through these readers."""
    for kind, names in CELLS.items():
        for name in names:
            e2e = {m["name"] for m in load_cell(name).end_to_end} - {"setup_s"}
            assert e2e and e2e <= set(OLD), name
