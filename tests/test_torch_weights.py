"""Port weights: the portable npz read without JAX, and JAX pytrees carried
over by ``params_from_numpy``."""

import os

import jax
import numpy as np
import pytest
import torch

from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
from d3feat_tpu_torch.compat.portable import path_to_name, read_npz
from d3feat_tpu_torch.compat.weights import load_npz, params_from_numpy
from d3feat_tpu_torch.config import D3FeatConfig
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from tests.torch_port_helpers import jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

R5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "artifacts", "model_best_acc_r5.npz")


@pytest.mark.parametrize("path,name", [
    ("['decoder'][1]['linear']['w']", "decoder.1.linear.w"),
    ("['encoder'][0]['conv'].weights", "encoder.0.conv.weights"),
    ("['encoder'][12]['conv'].kernel_points", "encoder.12.conv.kernel_points"),
    ("['encoder'][1]['unary1']['norm']['bias']", "encoder.1.unary1.norm.bias"),
])
def test_path_to_name(path, name):
    assert path_to_name(path) == name


@pytest.mark.parametrize("bad", ["", "encoder.0", "['a']x", "[0]['b'"])
def test_path_to_name_rejects_garbage(bad):
    with pytest.raises(ValueError):
        path_to_name(bad)


def test_r5_artifact_loads_to_equal_tensors():
    params, state, meta = read_npz(R5)
    assert len(params) == 146 and len(state) == 0
    assert meta["epoch"] == 114 and meta["config"]["use_batch_norm"] is False
    cfg = D3FeatConfig.from_dict(meta["config"])
    model = init_kpfcnn(cfg, device="cpu")
    load_npz(model, R5)
    sd = model.state_dict()
    assert set(sd) == set(params)
    with np.load(R5) as z:
        paths = [str(p) for p in z["__paths_params__"]]
        for i, p in enumerate(paths):
            assert torch.equal(sd[path_to_name(p)], torch.from_numpy(z[f"p_{i:05d}"]))


@pytest.mark.parametrize("num_layers", [2, 5])
def test_params_from_numpy_matches_model_names(num_layers):
    jcfg = jax_config(num_layers)
    params, _, _ = j_init(jax.random.key(1), jcfg)
    sd = params_from_numpy(jax.tree.map(np.asarray, params))
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    model.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(sd) == len(leaves)
    for path, leaf in leaves:
        assert np.array_equal(model.state_dict()[path_to_name(jax.tree_util.keystr(path))]
                              .numpy(), np.asarray(leaf))


def test_params_from_numpy_default_config_matches_r5_names():
    params, _, _ = j_init(jax.random.key(0), JConfig(experiment_id="d"))
    sd = params_from_numpy(jax.tree.map(np.asarray, params))
    r5, _, _ = read_npz(R5)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in r5.items()}
