"""The JAX recall reference of the gather route
(``tests/torch_port_recall_r5_gather.json``: the JAX package's own CPU
route, XLA searches and the gather KPConv, written by ``python -m
tests.torch_port_helpers --route cpu``) on its smallest scene, 424245: the
JAX package recomputes it, and the port's gather route on the CPU
(``neighbor_search='banded'``, which takes the branch JAX's ``'pallas'``
takes off a TPU) meets the rules that ``chip_smoke.py`` holds the card to
(``hold_recall``), without calling a kernel's twin. Full width, the r5
weights on their own config: minutes on the CPU, so ``slow``."""

import importlib.util
import json
import os

import pytest

from tests.torch_port_helpers import R5_NPZ, ROOT, jax_recall_reference

SEED = "424245"
REFERENCE = os.path.join(ROOT, "tests", "torch_port_recall_r5_gather.json")

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE) as f:
        return json.load(f)


def test_jax_reproduces_the_reference(reference):
    got = jax_recall_reference((int(SEED),), reference["meta"]["route"])
    assert got["meta"]["route"] == reference["meta"]["route"] == "cpu"
    assert json.loads(json.dumps(got["scenes"][SEED])) == reference["scenes"][SEED]


def test_port_gather_route_meets_the_reference_rules(reference):
    from d3feat_tpu_torch.final_recall import load_snapshot

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, model, _ = load_snapshot(R5_NPZ, "cpu")
    cfg.neighbor_search = "banded"
    scenes = {SEED: smoke.recall_scenes()[SEED]}
    with smoke.count_twins() as twins:
        got = smoke.recall_pass(cfg, model, scenes, device="cpu")
    assert not any(twins.values()), twins  # the gather route runs no kernel
    ref = {SEED: reference["scenes"][SEED]}
    assert smoke.hold_recall(ref, got, reference["meta"]["route"]) == []
    print(f"port gather route on the CPU, scene {SEED}: {got[SEED]['matched_pairs']}/"
          f"{got[SEED]['gt_pairs']} matched")
