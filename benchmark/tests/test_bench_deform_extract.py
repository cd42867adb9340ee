"""The deformable extraction cell (``d3feat-3dmatch-deform.extract-b8``) at
a tiny size on the CPU: the extractor serves the deformable model with its
own pyramid, so a sound run is correct; the bf16 control is not; a traced
run reads the deformable sums' counter; and K6's count of operations and
bytes on a hand-checked launch."""

import time

import pytest

from bench_tiny import tiny_cell, write_scene
from harness.cells import run_cell
from harness.manifest import load_cell, load_module

SEED = 2 ** 31 + 2222
CELL = "d3feat-3dmatch-deform.extract-b8"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene") / "scene_0.npz")


def _run(cell, traced=False, **kw):
    return run_cell(cell, SEED, 0.5, traced, time.time(), device="cpu", **kw)


def test_sound_run_is_correct(scene):
    out = _run(tiny_cell("extract", scene, deform=True))
    assert out["correct"], out["checks"]
    assert out["checks"]["pyramid_miss"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0


def test_bf16_control_is_not_correct(scene):
    out = _run(tiny_cell("extract", scene, deform=True), compute_dtype="bfloat16")
    assert not out["correct"], out["checks"]


def test_traced_run_reads_the_deformable_sums(scene):
    cell = tiny_cell("extract", scene, deform=True)
    cell.per_layer = load_cell(CELL).per_layer
    out = _run(cell, traced=True)
    assert out["correct"], out["checks"]
    # the CPU runs every deformable sum by the gather route, and holds no
    # device trace for K6's roofline
    assert out["metrics"]["deform_kernel_share.extract"]["value"] == 0.0
    assert "deform_conv_roofline.extract" not in out["metrics"]


def test_deform_conv_work_by_hand():
    work = load_module("counts", "deform_conv").work
    launch = {"kp": 2, "cin": 3, "q": 2, "s": 4, "pairs": 3, "per_query": False}
    # 3 pairs x 2 kernel points x (8 + 4 + 1 + 2 x 3) + 3 pairs x 3 channels
    # bytes: 4 x (2 x 3 queries + 4 x 3 supports + 4 x 3 features + 3 pairs
    #             + 2 x 3 kernel points + 2 x 2 x 3 sums + 2 densities)
    assert work(launch) == (123, 4 * 53)
    # per-query kernel points: 2 x 2 x 3 of them, and 2 x 2 least distances
    assert work(dict(launch, per_query=True)) == (123, 4 * (53 + 6 + 4))
