"""The port imports neither JAX nor the JAX package, and its entry points
do not fall back to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r'''
import importlib
import importlib.util
import pkgutil
import sys

BLOCKED = ("jax", "jaxlib", "d3feat_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:  # whole names: d3feat_tpu_torch passes
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import d3feat_tpu_torch
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)
mods = ["d3feat_tpu_torch"]
for info in pkgutil.walk_packages(d3feat_tpu_torch.__path__, "d3feat_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
TOOLS = ("scene_cache", "ab_recall", "final_recall", "gen_eval_cache", "test_3dmatch",
         "train_3dmatch", "gen_corpus")
assert not [m for m in sys.modules if m in TOOLS], [m for m in sys.modules if m in TOOLS]
for m in ("d3feat_tpu_torch.data.synthetic",
          "d3feat_tpu_torch.data.threedmatch", "d3feat_tpu_torch.data.ply",
          "d3feat_tpu_torch.data.augment", "d3feat_tpu_torch.utils.timer",
          "d3feat_tpu_torch.eval.gtlog", "d3feat_tpu_torch.eval.matching",
          "d3feat_tpu_torch.eval.registration", "d3feat_tpu_torch.eval.extract",
          "d3feat_tpu_torch.eval.scene_cache", "d3feat_tpu_torch.final_recall",
          "d3feat_tpu_torch.test_3dmatch", "d3feat_tpu_torch.compat.portable",
          "d3feat_tpu_torch.data.loader", "d3feat_tpu_torch.data.prepare",
          "d3feat_tpu_torch.data.calibrate",
          "d3feat_tpu_torch.train.checkpoint", "d3feat_tpu_torch.train.logging_utils",
          "d3feat_tpu_torch.train.trainer", "d3feat_tpu_torch.train_3dmatch",
          "d3feat_tpu_torch.gen_corpus", "d3feat_tpu_torch.models.kpcnn",
          "d3feat_tpu_torch.models.kernel_points", "d3feat_tpu_torch.losses.regularizers",
          "d3feat_tpu_torch.compat.torch_export", "d3feat_tpu_torch.compat.torch_import",
          "d3feat_tpu_torch.native", "d3feat_tpu_torch.utils.metrics",
          "d3feat_tpu_torch.utils.profiling"):
    assert m in mods, m
print(len(mods))
'''


def _run(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=cwd))


def test_port_imports_without_jax():
    res = _run(_BLOCKED_IMPORT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20


def test_blocker_blocks():
    res = _run(_BLOCKED_IMPORT.split("import d3feat_tpu_torch")[0] + "import d3feat_tpu.config\n")
    assert res.returncode != 0 and "blocked import of d3feat_tpu" in res.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the script would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                      if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_entry_points_need_cuda_or_explicit_cpu():
    from d3feat_tpu_torch import resolve_device
    from d3feat_tpu_torch.config import D3FeatConfig
    from d3feat_tpu_torch.models.kpcnn import init_kpcnn
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    assert resolve_device("cpu") == torch.device("cpu")
    cfg = D3FeatConfig(experiment_id="x", num_layers=2, first_features_dim=16)
    if torch.cuda.is_available():
        assert init_kpfcnn(cfg).encoder[0].conv.weights.is_cuda
        assert init_kpcnn(cfg).blocks[0].conv.weights.is_cuda
    else:
        for init in (init_kpfcnn, init_kpcnn):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                init(cfg)


def test_training_entry_point_needs_cuda_or_explicit_cpu(tmp_path):
    from d3feat_tpu_torch import train_3dmatch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the command would train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_3dmatch.main(["--synthetic", "--snapshot_root", str(tmp_path)])
    assert not os.listdir(tmp_path)  # nothing ran on the CPU
