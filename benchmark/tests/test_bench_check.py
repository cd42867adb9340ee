"""The check on whole runs at a tiny size on the CPU (the program's plain
twins in place of its kernels, the harness's look for a card skipped):
sound runs come out correct; the bf16 control and each fault that a cell
can have, planted in the timed path, come out not correct."""

import time

import pytest

from bench_tiny import tiny_cell, write_scene
from harness import faults
from harness.cells import run_cell

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene") / "scene_0.npz")


def _run(cell, seconds=0.5, **kw):
    return run_cell(cell, SEED, seconds, False, time.time(), device="cpu", **kw)


@pytest.mark.parametrize("kind", ["extract", "train"])
def test_sound_run_is_correct(scene, kind):
    out = _run(tiny_cell(kind, scene))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("kind", ["extract", "train"])
def test_bf16_control_is_not_correct(scene, kind):
    out = _run(tiny_cell(kind, scene), compute_dtype="bfloat16")
    assert not out["correct"], out["checks"]


def test_altered_answer(scene):
    with faults.altered_answer():
        assert not _run(tiny_cell("extract", scene))["correct"]


def test_half_the_group_left_out(scene):
    with faults.half_the_group():
        assert not _run(tiny_cell("extract", scene))["correct"]


def test_state_left_unchanged(scene):
    with faults.state_unchanged():
        out = _run(tiny_cell("train", scene))
    assert not out["correct"] and out["checks"]["update_gap"]["value"] > 0.5


def test_half_the_pairs_left_out(scene):
    with faults.half_the_pairs():
        assert not _run(tiny_cell("train", scene))["correct"]


@pytest.mark.parametrize("fault,number", [("lr_off", "update_gap"), ("momentum_off", "grad_gap")])
def test_optimizer_settings_off(scene, fault, number):
    with faults.FAULTS[fault]():
        out = _run(tiny_cell("train", scene))
    check = out["checks"][number]
    assert not out["correct"] and check["value"] > check["limit"], out["checks"]


def test_momentum_dropped_between_steps(scene):
    with faults.momentum_dropped():
        out = _run(tiny_cell("train", scene))
    assert not out["correct"] and out["checks"]["grad_gap"]["value"] > 0.5, out["checks"]


def test_traced_run_reads_per_layer(scene):
    from harness.manifest import load_cell

    cell = tiny_cell("extract", scene)
    cell.per_layer = load_cell("d3feat-3dmatch.extract-b8").per_layer
    out = run_cell(cell, SEED, 0.5, True, time.time(), device="cpu")
    assert out["correct"], out["checks"]
    # the CPU holds no device trace: the host's counters and spans only
    assert {"extract_pad_share", "extract_steps_per_group", "extract_mfu",
            "pyramid_ms.extract"} <= set(out["metrics"])
    assert out["metrics"]["extract_steps_per_group"]["value"] == 1.0
