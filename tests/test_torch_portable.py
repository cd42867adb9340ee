"""Port vs JAX: the portable params-only npz in both directions.

(a) the port's ``export_npz`` of a 3-layer model loads through JAX's
    ``import_npz`` into ``init_train_state``'s template to equal leaves,
    with the meta (an infinite best loss included);
(b) JAX's ``export_npz`` loads into the port through ``load_npz``;
(c) ``read_npz`` then ``export_npz`` of the committed r5 npz rewrites it:
    the same members, ``__paths_params__`` string for string, every array
    bit for bit and the meta;
(d) an architecture mismatch raises in both directions;
(e) a model with batch norm and modulated deformable convs: the port's
    ``export_model_npz`` loads through JAX's ``import_npz`` (the offset
    leaves and the running statistics in JAX's flatten order) to its
    parameters and buffers, and JAX's export of them loads back bit for
    bit; model state the model has no batch norm for raises."""

import os

import jax
import numpy as np
import pytest
import torch

from d3feat_tpu.compat.portable import export_npz as j_export_npz
from d3feat_tpu.compat.portable import import_npz as j_import_npz
from d3feat_tpu.train import init_train_state
from d3feat_tpu_torch.compat.portable import export_npz, name_to_path, path_to_name, read_npz
from d3feat_tpu_torch.compat.weights import load_npz, params_from_numpy
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from tests.torch_port_helpers import jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


R5 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "artifacts",
                  "model_best_acc_r5.npz")


def _jax_state(layers):
    return init_train_state(jax.random.key(0), jax_config(layers))[0]


def _port_model(layers, seed=1):
    return init_kpfcnn(torch_config(jax_config(layers)), seed=seed, device="cpu")


def test_port_export_loads_in_jax(tmp_path):
    model = _port_model(3)
    path = str(tmp_path / "port.npz")
    meta = {"epoch": 7, "best_loss": float("inf"), "best_acc": 12.5}
    export_npz(path, model.state_dict(), None, meta)
    ts = _jax_state(3)
    params, mstate, jmeta = j_import_npz(path, ts.params, ts.model_state)
    assert jmeta == meta
    assert jax.tree_util.tree_structure(mstate) == jax.tree_util.tree_structure(ts.model_state)
    got = params_from_numpy(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_jax_export_loads_in_port(tmp_path):
    ts = _jax_state(3)
    path = str(tmp_path / "jax.npz")
    j_export_npz(path, ts.params, ts.model_state, meta={"epoch": 3, "best_acc": 1.5})
    model = _port_model(3)
    assert load_npz(model, path) == {"epoch": 3, "best_acc": 1.5}
    want = params_from_numpy(jax.tree.map(np.asarray, ts.params))
    sd = model.state_dict()
    assert sorted(want) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k


def test_r5_round_trip_is_bitwise(tmp_path):
    params, state, meta = read_npz(R5)
    out = str(tmp_path / "r5.npz")
    export_npz(out, params, state, meta)
    with np.load(R5, allow_pickle=False) as a, np.load(out, allow_pickle=False) as b:
        assert a.files == b.files
        assert [str(p) for p in a["__paths_params__"]] == [str(p) for p in b["__paths_params__"]]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    assert read_npz(out)[2] == meta
    assert len(params) == 146 and not state


@pytest.mark.parametrize("path", ["['decoder'][13]['linear']['w']",
                                  "['encoder'][0]['conv'].weights",
                                  "['encoder'][2]['conv'].kernel_points"])
def test_paths_round_trip(path):
    assert name_to_path(path_to_name(path)) == path


def test_architecture_mismatch_raises_both_ways(tmp_path):
    port3 = str(tmp_path / "port3.npz")
    export_npz(port3, _port_model(3).state_dict())
    ts2 = _jax_state(2)
    with pytest.raises(ValueError, match="does not match"):
        j_import_npz(port3, ts2.params, ts2.model_state)
    jax2 = str(tmp_path / "jax2.npz")
    j_export_npz(jax2, ts2.params, ts2.model_state)
    with pytest.raises(RuntimeError, match="state_dict"):
        load_npz(_port_model(3), jax2)
    # same layers, another width: JAX refuses the shapes, the port too
    wide = init_kpfcnn(torch_config(jax_config(2, first_features_dim=32)), device="cpu")
    port_wide = str(tmp_path / "wide.npz")
    export_npz(port_wide, wide.state_dict())
    with pytest.raises(ValueError, match="shape"):
        j_import_npz(port_wide, ts2.params, ts2.model_state)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_npz(_port_model(2), port_wide)


def test_batch_norm_and_deformable_round_trip(tmp_path):
    from d3feat_tpu.config import D3FeatConfig as JConfig
    from d3feat_tpu_torch.compat.weights import export_model_npz, model_trees, state_from_numpy
    from d3feat_tpu_torch.config import D3FeatConfig as TConfig

    arch = ["simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
            "nearest_upsample", "last_unary"]

    class JD(JConfig):
        def architecture(self):
            return list(arch)

    class TD(TConfig):
        def architecture(self):
            return list(arch)

    d = jax_config(2, use_batch_norm=True, modulated=True).to_dict()
    jcfg, tcfg = JD.from_dict(d), TD.from_dict(d)
    ts = init_train_state(jax.random.key(0), jcfg)[0]
    model = init_kpfcnn(tcfg, seed=3, device="cpu")
    with torch.no_grad():  # running statistics other than their initial 0 and 1
        for n, b in model.named_buffers():
            if n.endswith((".mean", ".var")):
                b.uniform_(0.5, 1.5)
    path = str(tmp_path / "port.npz")
    export_model_npz(path, model, meta={"epoch": 1})
    jp, js, _ = j_import_npz(path, ts.params, ts.model_state)
    params, state = model_trees(model)
    assert sum(k.endswith("offset_weights") for k in params) == 2
    got = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert sorted(got) == sorted(params) and all(torch.equal(got[k], params[k]) for k in got)
    bufs = dict(model.named_buffers())
    got = state_from_numpy(jax.tree.map(np.asarray, js), model)
    assert len(got) == len(state) > 0 and all(torch.equal(got[k], bufs[k]) for k in got)

    back = str(tmp_path / "jax.npz")
    j_export_npz(back, jp, js)
    model2 = init_kpfcnn(tcfg, seed=4, device="cpu")
    load_npz(model2, back)
    sd = model.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in model2.state_dict().items())
    with pytest.raises(ValueError, match="no batch norm"):
        load_npz(init_kpfcnn(torch_config(jax_config(2)), device="cpu"), back)
