"""The port's ``Trainer`` on the CPU (3 layers, width 16, 220-point
synthetic pairs): resume from a periodic snapshot reproduces the
continuing run's next step bit for bit (weights, momentum, step count,
metrics); the npz warm start takes its epoch and bests from the meta and
keeps a fresh optimizer; the autoexported npz loads through JAX's
``import_npz`` to the best-accuracy snapshot's weights; a non-finite step
counts in ``skipped``; ``num_devices=2`` and ``device="cuda"`` without CUDA
raise before anything runs; with batch norm, snapshots and the autoexport
carry the running statistics and a resume is bit for bit; the
``config.json`` the port writes loads through JAX's
``D3FeatConfig.from_json``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from d3feat_tpu.compat.portable import import_npz as j_import_npz
from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.train import init_train_state
from d3feat_tpu_torch.compat.portable import export_npz
from d3feat_tpu_torch.compat.weights import optimizer_state_by_name, params_from_numpy
from d3feat_tpu_torch.data.loader import PairLoader
from d3feat_tpu_torch.data.synthetic import SyntheticPairDataset
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.train.checkpoint import BEST_ACC, SnapshotManager
from d3feat_tpu_torch.train.optim import train_tensors
from d3feat_tpu_torch.train.trainer import Trainer
from tests.torch_port_helpers import CAPS, jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def tiny_config(tmp, **kw):
    cfg = torch_config(jax_config(3))
    cfg.max_epoch = 2
    cfg.training_max_iter = 2
    cfg.val_max_iter = 1
    cfg.snapshot_interval = 1
    cfg.snapshot_root = str(tmp)
    cfg.experiment_id = "run"
    cfg.verbose = False
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def loader(size=4, seed=0, dataset=None):
    ds = dataset or SyntheticPairDataset(size=size, n_points=220, num_corr=8, seed=seed)
    return PairLoader(ds, point_capacity=CAPS[0], corr_capacity=8, num_workers=2, seed=seed)


def fixed_batch(tr, seed=7):
    it = iter(loader(seed=seed))
    batch = tr._device_put(next(it))
    it.close()
    return batch


def state_of(tr):
    """(weights, momentum, step) of a trainer, cloned."""
    w = {n: t.detach().clone() for n, t in train_tensors(tr.state.model)}
    m = {n: v.clone() for n, v in optimizer_state_by_name(
        tr.state.model, tr.state.optimizer).get("momentum_buffer", {}).items()}
    return w, m, tr.state.step


def assert_same_state(a, b):
    assert a[2] == b[2]
    for i in (0, 1):
        assert sorted(a[i]) == sorted(b[i])
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), k


def test_resume_reproduces_the_next_step(tmp_path):
    cfg = tiny_config(tmp_path, max_epoch=1)
    tr = Trainer(cfg, loader(), loader(seed=1), device="cpu")
    tr.train()
    snap = tr.snapshots.directory
    assert tr.snapshots.latest_periodic() == "snapshot_epoch_1"
    assert tr.state.step == 2

    cfg2 = tiny_config(tmp_path, experiment_id="resumed",
                       pretrain=os.path.join(snap, "snapshot_epoch_1"))
    tr2 = Trainer(cfg2, loader(), None, device="cpu")
    assert tr2.start_epoch == 1 and tr2.global_iter == 2
    assert (tr2.best_loss, tr2.best_acc) == (tr.best_loss, tr.best_acc)
    assert_same_state(state_of(tr), state_of(tr2))

    batch = fixed_batch(tr)
    tr.state, m1 = tr._train_step(tr.state, batch, 1)
    tr2.state, m2 = tr2._train_step(tr2.state, batch, 1)
    assert m1 == m2 and m1.skipped == 0.0
    assert_same_state(state_of(tr), state_of(tr2))
    assert tr2.state.step == 3


def test_npz_warm_start_takes_meta_and_fresh_optimizer(tmp_path):
    cfg = tiny_config(tmp_path)
    donor = init_kpfcnn(cfg, seed=5, device="cpu")
    npz = str(tmp_path / "w.npz")
    export_npz(npz, donor.state_dict(), None,
               meta={"epoch": 41, "best_loss": 2.45, "best_acc": 30.47})
    tr = Trainer(tiny_config(tmp_path, pretrain=npz), loader(), None, device="cpu")
    assert tr.start_epoch == 41 and tr.global_iter == 41 * 2
    assert (tr.best_loss, tr.best_acc) == (2.45, 30.47)
    assert tr.state.step == 0 and not tr.state.optimizer.state
    for k, v in donor.state_dict().items():
        assert torch.equal(tr.state.model.state_dict()[k], v), k


def test_autoexport_loads_in_jax(tmp_path):
    auto = str(tmp_path / "export" / "best.npz")
    cfg = tiny_config(tmp_path, autoexport=auto)
    tr = Trainer(cfg, loader(), loader(seed=1), device="cpu")
    tr.train()
    assert tr.best_acc > 0.0 and os.path.exists(auto)  # validation accuracy rose above 0
    assert not os.path.exists(auto + ".tmp.npz")
    with open(os.path.join(tr.snapshots.directory, BEST_ACC + ".meta.json")) as f:
        best = json.load(f)
    ts = init_train_state(jax.random.key(0), jax_config(3))[0]
    params, _, meta = j_import_npz(auto, ts.params, ts.model_state)
    assert meta["epoch"] == best["epoch"] and meta["best_acc"] == best["best_acc"] == tr.best_acc
    assert meta["config"] == json.loads(json.dumps(cfg.to_dict()))
    model = init_kpfcnn(cfg, device="cpu")
    SnapshotManager(tr.snapshots.directory).restore_model(BEST_ACC, model)
    got = params_from_numpy(jax.tree.map(np.asarray, params))
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


class _NaNPairs(SyntheticPairDataset):
    def packed(self, index, **kw):
        p = super().packed(index, **kw)
        p.features[0, 0] = np.nan
        return p


def test_nonfinite_step_counts_in_skipped(tmp_path):
    nan = _NaNPairs(size=2, n_points=220, num_corr=8)
    tr = Trainer(tiny_config(tmp_path), loader(dataset=nan), None, device="cpu")
    before = state_of(tr)
    res = tr.train_epoch(0)
    assert res["skipped"] == 1.0 and tr.global_iter == 2
    assert_same_state(before, state_of(tr))


def test_unported_settings_raise(tmp_path):
    with pytest.raises(RuntimeError, match="initialised process group"):
        Trainer(tiny_config(tmp_path, num_devices=2), loader(), None, device="cpu")
    # batch norm is ported: on one device the trainer builds (with two, the
    # data-parallel step refuses it: tests/test_torch_data_parallel.py (e))
    tr = Trainer(tiny_config(tmp_path, use_batch_norm=True), loader(), None, device="cpu")
    assert any(n.endswith(".mean") for n, _ in tr.state.model.named_buffers())


def test_batch_norm_snapshots_resume_and_export(tmp_path):
    """With batch norm the snapshots carry the running statistics: a resume
    holds them bit for bit and reproduces the next step's, and the
    autoexported npz holds them as JAX model state."""
    from d3feat_tpu_torch.compat.weights import load_npz, state_from_numpy

    auto = str(tmp_path / "best.npz")
    cfg = tiny_config(tmp_path, max_epoch=1, use_batch_norm=True, autoexport=auto)
    tr = Trainer(cfg, loader(), loader(seed=1), device="cpu")
    tr.train()
    cfg2 = tiny_config(tmp_path, experiment_id="resumed", use_batch_norm=True,
                       pretrain=os.path.join(tr.snapshots.directory, "snapshot_epoch_1"))
    tr2 = Trainer(cfg2, loader(), None, device="cpu")

    def buffers(t):
        return {n: b.clone() for n, b in t.state.model.named_buffers()}

    b1 = buffers(tr)
    assert float(tr.state.model.encoder[0].norm.mean.abs().max()) > 0.0
    assert all(torch.equal(b1[n], b) for n, b in buffers(tr2).items())
    batch = fixed_batch(tr)
    tr.state, m1 = tr._train_step(tr.state, batch, 1)
    tr2.state, m2 = tr2._train_step(tr2.state, batch, 1)
    assert m1 == m2
    assert_same_state(state_of(tr), state_of(tr2))
    b1, b2 = buffers(tr), buffers(tr2)
    assert all(torch.equal(b1[n], b2[n]) for n in b1)

    jcfg = jax_config(3, use_batch_norm=True)
    ts = init_train_state(jax.random.key(0), jcfg)[0]
    _, jstate, _ = j_import_npz(auto, ts.params, ts.model_state)
    best = init_kpfcnn(cfg, device="cpu")
    SnapshotManager(tr.snapshots.directory).restore_model(BEST_ACC, best)
    want = dict(best.named_buffers())
    got = state_from_numpy(jax.tree.map(np.asarray, jstate), best)
    assert len(got) == 2 * 26 and all(torch.equal(got[n], want[n]) for n in got)
    back = init_kpfcnn(cfg, device="cpu")
    load_npz(back, auto)
    assert all(torch.equal(v, best.state_dict()[k]) for k, v in back.state_dict().items())


def test_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(tiny_config(tmp_path), loader(), None)
    assert not os.path.exists(tmp_path / "run")  # nothing ran on the CPU


def test_config_json_loads_in_jax(tmp_path):
    cfg = tiny_config(tmp_path, corpus_rotation="mix", compute_dtype="bfloat16")
    Trainer(cfg, loader(), None, device="cpu")
    path = os.path.join(str(tmp_path), "run", "config.json")
    assert JConfig.from_json(path).to_dict() == cfg.to_dict()
