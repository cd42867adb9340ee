"""The port's training entry points: ``config.get_config`` against JAX's
on the same argv; ``python3 -m d3feat_tpu_torch.train_3dmatch --synthetic
--cpu`` at a 3-layer config writes its snapshots, metrics and autoexported
npz; ``final_recall``'s ``--snapshot <dir> --name`` and ``test_3dmatch
--chosen_snapshot`` load what it wrote; ``make_loaders`` builds the JAX
script's loaders on every route; ``gen_corpus`` writes the JAX tool's
scene files. The training subprocess runs torch on one thread, as the
test process does (``tests/torch_port_helpers.py::one_torch_thread``)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from d3feat_tpu.config import get_config as j_get_config
from d3feat_tpu_torch.config import get_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [
    ["--experiment_id", "x"],
    ["--experiment_id", "y", "--num_layers", "3", "--lr", "0.05", "--verbose", "false",
     "--use_batch_norm", "True", "--corpus_rotation", "mix", "--cap_points", "512", "256", "128",
     "--cap_neighbors", "14", "14", "14", "--cap_corr", "8", "--scheduler_gamma", "0.5",
     "--pretrain", "a.npz", "--compute_dtype", "bfloat16"],
])
def test_get_config_matches_jax(argv):
    assert get_config(argv).to_dict() == j_get_config(argv).to_dict()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(snapshot directory, autoexported npz) of one CLI run on the CPU."""
    root = str(tmp_path_factory.mktemp("cli"))
    auto = os.path.join(root, "best.npz")
    argv = ["--synthetic", "--cpu", "--num_layers", "3", "--first_features_dim", "16",
            "--first_subsampling_dl", "0.05", "--cap_points", "4096", "1024", "256",
            "--cap_neighbors", "32", "32", "32", "--cap_corr", "64", "--num_node", "32",
            "--max_epoch", "2", "--training_max_iter", "1", "--val_max_iter", "1",
            "--snapshot_interval", "1", "--snapshot_root", root, "--experiment_id", "run",
            "--autoexport", auto, "--num_workers", "2"]
    res = subprocess.run([sys.executable, "-m", "d3feat_tpu_torch.train_3dmatch", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    return os.path.join(root, "run"), auto, res.stdout


def test_cli_writes_snapshots_and_npz(trained):
    snap, auto, out = trained
    for name in ("config.json", "metrics.jsonl", "snapshot_epoch_1", "snapshot_epoch_2",
                 "model_final", "model_best_loss", "model_best_acc"):
        assert os.path.exists(os.path.join(snap, name)), name
    assert os.path.exists(auto) and "autoexport" in out
    with open(os.path.join(snap, "model_final.meta.json")) as f:
        assert json.load(f)["epoch"] == 2
    with open(os.path.join(snap, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]


def test_recall_entry_points_load_snapshots(trained):
    from d3feat_tpu_torch import final_recall, test_3dmatch
    from d3feat_tpu_torch.train.checkpoint import STATE_FILE

    snap, auto, _ = trained
    args = final_recall.parse_args(["--snapshot", snap, "--name", "model_final", "--cpu"])
    cfg, model, meta = final_recall.load_snapshot(args.snapshot, "cpu", name=args.name)
    assert cfg.num_layers == 3 and meta["epoch"] == 2
    saved = torch.load(os.path.join(snap, "model_final", STATE_FILE), weights_only=True)
    for k, v in saved["model"].items():
        assert torch.equal(model.state_dict()[k], v), k
    # the autoexport is the best-accuracy snapshot's weights
    best = final_recall.load_snapshot(snap, "cpu")[1].state_dict()
    exported = final_recall.load_snapshot(auto, "cpu")[1].state_dict()
    assert all(torch.equal(best[k], exported[k]) for k in best)

    targs = test_3dmatch.parse_args(["--chosen_snapshot", snap, "--snapshot_name",
                                     "model_final", "--cpu", "--synthetic"])
    tcfg, tmodel = test_3dmatch.load_model(targs, torch.device("cpu"))
    assert tcfg.to_dict() == cfg.to_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(tmodel.state_dict()[k], v), k


def test_gen_corpus_writes_the_jax_tools_scenes(tmp_path, monkeypatch):
    """The port's ``gen_corpus`` and the JAX tool (``tools/gen_corpus.py``)
    write the same scene files from the same arguments."""
    import importlib.util

    from d3feat_tpu_torch import gen_corpus

    args = ["--count", "3", "--resolution", "40", "30", "--max-points", "3000",
            "--min-corr", "64", "--warp-max", "2.5"]
    spec = importlib.util.spec_from_file_location("jax_gen_corpus",
                                                  os.path.join(ROOT, "tools", "gen_corpus.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["gen_corpus.py", "--out", str(tmp_path / "jax"), *args])
    tool.main()
    assert gen_corpus.main(["--out", str(tmp_path / "port"), *args]) == 0
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) >= 2
    for f in files:
        with np.load(tmp_path / "jax" / f) as a, np.load(tmp_path / "port" / f) as b:
            assert sorted(a.files) == sorted(b.files) == ["pairs", "w0", "w1"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def _attrs(obj):
    """The plain settings of a dataset or loader (numbers, strings, tuples)."""
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, (bool, int, float, str, tuple)) and k != "root"}


@pytest.mark.parametrize("route", ["synthetic", "scan", "corpus", "3dmatch"])
def test_make_loaders_matches_jax(route, tmp_path):
    """Each route of ``make_loaders`` builds the JAX script's datasets and
    loaders: same classes, settings, lengths and shuffle draws."""
    import importlib.util
    import pickle

    from d3feat_tpu_torch import train_3dmatch

    spec = importlib.util.spec_from_file_location("jax_train_3dmatch",
                                                  os.path.join(ROOT, "train_3dmatch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    argv = ["--experiment_id", "x", "--root", str(tmp_path), "--training_max_iter", "5",
            "--val_max_iter", "3", "--seed", "4", "--corpus_rotation", "mix"]
    corpus = None
    if route == "corpus":
        corpus = str(tmp_path / "corpus")
        os.makedirs(corpus)
        for i in (0, 1, 2, 50):
            np.savez(os.path.join(corpus, f"scene_{i:06d}.npz"), w0=np.zeros((300, 3)),
                     w1=np.zeros((300, 3)), pairs=np.zeros((8, 2), np.int32))
    if route == "3dmatch":
        for split in ("train", "val"):
            pts = {f"s/cloud_bin_{i}": np.zeros((10 + i, 3), np.float32) for i in range(3)}
            kp = {"s/cloud_bin_0@s/cloud_bin_1": np.zeros((4, 2), np.int32),
                  "s/cloud_bin_1@s/cloud_bin_2": np.zeros((4, 2), np.int32)}
            for tag, obj in (("points", pts), ("keypts", kp)):
                with open(tmp_path / f"3DMatch_{split}_0.030_{tag}.pkl", "wb") as f:
                    pickle.dump(obj, f)
    flags = (route == "synthetic", route == "scan", corpus)
    jl = tool.make_loaders(j_get_config(argv), *flags)
    tl = train_3dmatch.make_loaders(get_config(argv), *flags)
    for a, b in zip(jl, tl):
        assert type(a.dataset).__name__ == type(b.dataset).__name__
        assert _attrs(a.dataset) == _attrs(b.dataset) and len(a.dataset) == len(b.dataset)
        assert _attrs(a) == _attrs(b) and len(a) == len(b)
        np.testing.assert_array_equal(a._epoch_indices(), b._epoch_indices())
