"""The JAX recall reference (``tests/torch_port_recall_r5.json``) on its
smallest scene, 424245 (11 gt pairs): the JAX package recomputes it on the
file's route, and the port's twins on the CPU meet the rules that
``chip_smoke.py`` holds the card to (``hold_recall``). Full width, the r5
weights on their own config: minutes on the CPU, so ``slow``."""

import importlib.util
import json
import os

import pytest

from tests.torch_port_helpers import R5_NPZ, RECALL_REFERENCE, ROOT, jax_recall_reference

SEED = "424245"

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def reference():
    with open(RECALL_REFERENCE) as f:
        return json.load(f)


def test_jax_reproduces_the_reference(reference):
    got = jax_recall_reference((int(SEED),), reference["meta"]["route"])
    assert got["meta"]["route"] == reference["meta"]["route"] == "band"
    assert json.loads(json.dumps(got["scenes"][SEED])) == reference["scenes"][SEED]


def test_port_twins_meet_the_reference_rules(reference):
    from d3feat_tpu_torch.final_recall import load_snapshot

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, model, _ = load_snapshot(R5_NPZ, "cpu")
    scenes = {SEED: smoke.recall_scenes()[SEED]}
    with smoke.count_twins() as twins:
        got, secs = smoke.recall_pass(cfg, model, scenes, device="cpu")
    # the CPU runs the twins of K1, K2 and K3 (K2's twin works on the windows)
    assert all(twins[n] > 0 for n in ("select_plain", "band_conv_plain",
                                             "band_head_plain"))
    ref = {SEED: reference["scenes"][SEED]}
    assert smoke.hold_recall(ref, got, reference["meta"]["route"]) == []
    print(f"port twins on the CPU, scene {SEED}: {got[SEED]['matched_pairs']}/"
          f"{got[SEED]['gt_pairs']} matched, {secs:.1f} s")
