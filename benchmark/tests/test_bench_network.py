"""A configuration that names another network than D3Feat's KPFCNN runs
through ``run_cell`` with no edit to the harness: a tiny KP-CNN (KPConv's
classifier, batch norm on, an encoder ending in ``global_average``) driven
by a kind of this test's own, which reads ``train_steps_per_s``. A KP-CNN
configuration without its block list, and a network the harness does not
know, are refused."""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_tiny import tiny_cell, write_scene
from harness import cells, program
from harness.cells import run_cell
from harness.manifest import ROOT
from harness.traffic import load_scenes

SEED = 2 ** 31 + 4242
ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
        "global_average"]
# kernel points at the centre: isotropic convs, enough for a run to train on
RULE = {"draw": ["weights", "w"], "zeros": ["b", "offset", "mean", "kernel_points"],
        "ones": ["scale", "var"]}
BATCH_NORM = ("scale", "offset", "mean", "var")


class ClassifyKind:
    """A kind for this test only: ``clouds`` fragments of the mix's scene a
    step, one label each, through the port's pyramid (``train/step.py``'s
    ``build_pyramid``, so the benchmark's wrapper counts it), ``apply_kpcnn``
    in training mode, cross entropy, its backward and an SGD step."""

    seen = {}

    @classmethod
    def run(cls, ctx):
        import d3feat_tpu_torch.train.step as step
        from d3feat_tpu_torch.config import D3FeatConfig
        from d3feat_tpu_torch.data.pack import pack_fragments
        from d3feat_tpu_torch.models.kpcnn import apply_kpcnn, kpcnn_loss
        from d3feat_tpu_torch.ops.neighbors import permute_rows
        from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec

        cls.seen.update(model=ctx.model, start={k: v.detach().clone()
                                                for k, v in ctx.model.state_dict().items()})
        spec = ctx.cell.traffic
        frags, _ = load_scenes(spec["scenes"])
        clouds = frags[: spec["clouds"]]
        packed = pack_fragments(clouds, point_capacity=ctx.cfg.caps.points[0],
                                num_clouds=len(clouds))
        batch = {k: torch.from_numpy(v).to(ctx.device) for k, v in packed.items()}
        labels = torch.arange(len(clouds), device=ctx.device) % ctx.cfg.num_classes
        # the pyramid of D3Feat's list at the same depth: the port's walk of a
        # block list stops at ``global_average`` before closing its last level
        pyr_spec = make_pyramid_spec(D3FeatConfig.from_dict(ctx.cfg.to_dict()),
                                     num_clouds=len(clouds))
        opt = torch.optim.SGD(ctx.model.parameters(), lr=1e-3)

        def train_step():
            pyr = step.build_pyramid(batch["points"], batch["lengths"], spec=pyr_spec)
            order0, _ = step.sorted_order(pyr)
            feats = batch["features"] if order0 is None else permute_rows(batch["features"],
                                                                          order0)
            out = apply_kpcnn(ctx.model, dict(pyr, features=feats), train=True)
            loss, _ = kpcnn_loss(out.logits, labels, out.auxes, ctx.cfg)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return float(loss.detach())

        for _ in range(int(spec["warmup"])):
            train_step()
        n, losses = 0, []
        with ctx.window() as win:
            while win.open():
                losses.append(train_step())
                n += 1
        return SimpleNamespace(win=win, calls=n, done=n, failed=0, losses=losses)

    @staticmethod
    def check_numbers(res, ctx):
        return {"loss_not_finite": int(not np.isfinite(res.losses).all())}


def kpcnn_cell(scene, **change):
    cell = tiny_cell("train", scene)
    cfg = dict(cell.config, network="kpcnn", architecture=ARCH, use_batch_norm=True,
               num_classes=10, weights=RULE)
    cfg.update(change)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    return dataclasses.replace(
        cell, name="tiny.classify", config=cfg,
        traffic={"kind": "classify_tiny", "scenes": scene, "clouds": 3, "warmup": 1},
        limits={"loss_not_finite": 0})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return write_scene(tmp_path_factory.mktemp("scene") / "scene_0.npz", n=300)


@pytest.fixture
def kind(monkeypatch):
    """``load_module`` finds this test's kind; every other file as before."""
    real = cells.load_module
    monkeypatch.setattr(cells, "load_module", lambda what, name: ClassifyKind
                        if (what, name) == ("kinds", "classify_tiny") else real(what, name))
    ClassifyKind.seen.clear()
    return ClassifyKind


def test_kpcnn_cell_runs_to_its_end(scene, kind):
    from d3feat_tpu_torch.models.kpcnn import KPCNN

    out = run_cell(kpcnn_cell(scene), SEED, 0.5, False, time.time(), device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["metrics"]["train_steps_per_s"]["value"] > 0
    model, start = kind.seen["model"], kind.seen["start"]
    assert isinstance(model, KPCNN) and model.specs.blocks[-1].kind == "global_average"
    norms = {k: v for k, v in start.items() if k.rsplit(".", 1)[-1] in BATCH_NORM}
    # simple's, 5 resnetb's 3 each and 3 shortcuts', the head's 2: 4 leaves each
    assert len(norms) == 4 * (1 + 5 * 3 + 3 + 2)
    for k, v in norms.items():
        want = 1.0 if k.endswith((".scale", ".var")) else 0.0
        assert bool((v == want).all()), k


def test_batch_norm_leaves_by_rule():
    """``make_weights``'s ``ones`` and ``zeros`` rules on a KP-CNN's leaves,
    each other leaf drawn from the seed."""
    doc = dict(tiny_cell("train", "unused").config, network="kpcnn", architecture=ARCH,
               use_batch_norm=True, num_classes=10)
    cfg = program.make_config(doc)
    model, weights = program.build_model(cfg, "kpcnn", RULE, SEED, "cpu", ROOT)
    leaves = {k.rsplit(".", 1)[-1] for k in weights}
    assert {"scale", "offset", "mean", "var", "w", "b", "weights"} <= leaves
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k
        if k.endswith((".scale", ".var")):
            assert bool((v == 1).all()), k
        elif k.endswith((".offset", ".mean", ".b")):
            assert bool((v == 0).all()), k


def test_kpcnn_without_architecture_is_refused(scene, kind):
    with pytest.raises(ValueError, match="states its architecture"):
        run_cell(kpcnn_cell(scene, architecture=None), SEED, 0.5, False, time.time(),
                 device="cpu")


def test_unknown_network_is_refused(scene, kind):
    with pytest.raises(ValueError, match=r"'kpfcnn'.*'kpcnn'|'kpcnn'.*'kpfcnn'"):
        run_cell(kpcnn_cell(scene, network="pointnet"), SEED, 0.5, False, time.time(),
                 device="cpu")
