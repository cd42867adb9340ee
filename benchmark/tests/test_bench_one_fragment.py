"""Calls of one fragment (``d3feat-3dmatch.extract-b1``) at a tiny size on
the CPU: the extractor packs one fragment as the lengths ``[n, 0]``, which
the check reads as the fragment and one empty slot after it, so a sound
run is correct with no pyramid miss; the bf16 control and each planted
extraction fault are not. The cell's per-layer metrics are its ``.one``
readers, which read only where every call is one fragment."""

import os
import time

import numpy as np
import pytest

from bench_tiny import tiny_cell, write_scene
from harness import cells, faults
from harness.cells import run_cell
from harness.check import group_lengths
from harness.manifest import BENCH_DIR, load_cell, load_module

SEED = 2 ** 31 + 3131
ONE = "d3feat-3dmatch.extract-b1"


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene") / "scene_0.npz")


def _run(scene, **kw):
    cell = tiny_cell("extract", scene, batch_fragments=1)
    cell.traffic["check_groups"] = 2
    return run_cell(cell, SEED, 1.5, False, time.time(), device="cpu", **kw)


def test_sound_run_is_correct(scene):
    out = _run(scene)
    assert out["correct"], out["checks"]
    assert out["checks"]["pyramid_miss"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["extract_fragments_per_s"]["value"] > 0


def _base(name):
    """The reader a ``.one`` metric reads through: ``X.one`` reads ``X``, or
    ``X.extract`` where the extraction cells' metric has that name."""
    base = name[:-len(".one")]
    return base if os.path.isfile(os.path.join(BENCH_DIR, "metrics", base + ".py")) \
        else base + ".extract"


@pytest.mark.parametrize("traced", [False, True])
def test_one_fragment_readers(scene, monkeypatch, traced):
    """The cell's per-layer metrics are its own ``.one`` readers: on a run of
    one fragment a call each reads what the extraction cells' reader reads,
    the rate among them; on a run of groups each reads nothing."""
    runs = []
    real = cells.load_module

    def load(what, name):
        mod = real(what, name)
        if what != "metrics":
            return mod

        class Reader:
            @staticmethod
            def read(run):
                runs.append(run)
                return mod.read(run)
        return Reader

    monkeypatch.setattr(cells, "load_module", load)
    one = load_cell(ONE).per_layer
    assert one and all(m["name"].endswith(".one") for m in one)
    assert all(m["moves"] == "extract_group_p95_ms" for m in one)
    for b, reads in ((1, True), (2, False)):
        cell = tiny_cell("extract", scene, batch_fragments=b)
        cell.per_layer = one
        runs.clear()
        out = run_cell(cell, SEED, 1.0, traced, time.time(), device="cpu")
        assert out["correct"], out["checks"]
        run = runs[0]
        for m in one:
            got = load_module("metrics", m["name"]).read(run)
            if reads:
                assert got == load_module("metrics", _base(m["name"])).read(run), m["name"]
            else:
                assert got is None, m["name"]
        rate = load_module("metrics", "extract_fragments_per_s.one").read(run)
        assert (rate is not None and rate > 0) == reads


def test_bf16_control_is_not_correct(scene):
    assert not _run(scene, compute_dtype="bfloat16")["correct"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_the_group"])
def test_fault_is_not_correct(scene, fault):
    with faults.FAULTS[fault]():
        out = _run(scene)
    assert not out["correct"], out["checks"]
    assert out["checks"]["desc_off_share"]["value"] > out["checks"]["desc_off_share"]["limit"]


def test_answer_that_is_not_a_number_is_off(scene, monkeypatch):
    """A descriptor row of NaN reads as off, not as within the tolerance."""
    import d3feat_tpu_torch.eval.extract as ex

    orig = ex.FeatureExtractor.extract_many

    def nan_rows(self, clouds):
        out = orig(self, clouds)
        d, s = out[-1]
        d = d.copy()
        d[: len(d) // 2] = np.nan
        return out[:-1] + [(d, s)]

    monkeypatch.setattr(ex.FeatureExtractor, "extract_many", nan_rows)
    out = _run(scene)
    assert not out["correct"] and out["checks"]["desc_off_share"]["value"] >= 49.0, out["checks"]


@pytest.mark.parametrize("group, clouds, want", [
    ([[0] * 5], 2, [5, 0]),              # one fragment, packed [n, 0]
    ([[0] * 5, [0] * 3], 2, [5, 3]),     # a full group
    ([[0] * 5, [0] * 3], 4, [5, 3, 0, 0]),
    ([[0] * 5, [0] * 3], 1, [5, 3]),     # more fragments than slots: a miss
])
def test_group_lengths(group, clouds, want):
    assert group_lengths(group, clouds) == want


@pytest.mark.parametrize("per_call, fragments, want", [
    # one fragment a call: 8 calls a block, the share over the block's rows
    ([(1000, 210)] + [(1000, 0)] * 15, 1, 210 / 80),
    # a group of 8 is a block of its own
    ([(8000, 80), (8000, 800)], 8, 10.0),
])
def test_shares_over_blocks_of_8_fragments(monkeypatch, per_call, fragments, want):
    from types import SimpleNamespace

    from harness import check
    from harness.manifest import load_module

    kind = load_module("kinds", "extract")
    monkeypatch.setattr(check, "check_group", lambda group, outputs, kept, *a: {
        "pyramid_miss": 0, "rows": kept[0], "desc_off_rows": kept[1], "clear_rows": kept[0],
        "score_off_rows": 0})
    res = SimpleNamespace(kept={i: ([[0]] * fragments, None, c) for i, c in enumerate(per_call)})
    ctx = SimpleNamespace(weights=None, cfg_doc=None, arch=None, device="cpu")
    nums = kind.check_numbers(res, ctx)
    assert nums == {"pyramid_miss": 0, "desc_off_share": pytest.approx(want),
                    "score_off_share": 0.0}
