"""TPU-trained weights -> reference torch checkpoint export.

Round-trips our parameter tree through the reference ``state_dict`` layout
(export -> import == identity) and, stronger, loads the exported dict into
the ACTUAL reference torch KPFCNN with ``strict=True`` — proving a model
trained in this framework deploys into reference-side tooling unchanged
(reference checkpoint format: trainer.py:197-210; module tree:
models/architectures.py:216-320).
"""

import os
import sys

import numpy as np
import jax
import pytest

REF = "/root/reference"

from d3feat_tpu.compat.torch_export import (  # noqa: E402
    export_state_dict,
    save_torch_checkpoint,
)
from d3feat_tpu.compat.torch_import import (  # noqa: E402
    convert_state_dict,
    load_torch_checkpoint,
)
from d3feat_tpu.config import D3FeatConfig, PyramidCaps  # noqa: E402
from d3feat_tpu.models import make_kpfcnn_specs  # noqa: E402
from d3feat_tpu.models.kpfcnn import init_kpfcnn  # noqa: E402
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _cfg(num_layers=3, use_bn=False):
    cfg = D3FeatConfig()
    cfg.num_layers = num_layers
    cfg.first_features_dim = 32
    cfg.use_batch_norm = use_bn
    cfg.caps = PyramidCaps(points=(2048,) * num_layers,
                           neighbors=(16,) * num_layers, corr=32)
    return cfg


@pytest.mark.parametrize("use_bn", [False, True])
def test_export_import_roundtrip(use_bn):
    cfg = _cfg(use_bn=use_bn)
    params, state, specs = init_kpfcnn(jax.random.key(0), cfg)
    sd = export_state_dict(params, state, cfg, specs)
    params2, state2 = convert_state_dict(sd, cfg, specs, strict=True)

    flat1 = jax.tree_util.tree_leaves(params)
    flat2 = jax.tree_util.tree_leaves(params2)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exported_dict_loads_into_reference_model():
    if not os.path.isdir(REF):
        pytest.skip("reference mount unavailable")
    if REF not in sys.path:
        sys.path.insert(0, REF)
    import torch
    from models.architectures import KPFCNN as RefKPFCNN  # type: ignore

    from tools.ab_recall import ref_config_ns  # noqa: E402

    cfg = _cfg()
    params, state, specs = init_kpfcnn(jax.random.key(1), cfg)
    sd = {
        k: (torch.from_numpy(v.copy()) if v.dtype != np.int64
            else torch.tensor(int(v)))
        for k, v in export_state_dict(params, state, cfg, specs).items()
    }
    ref = RefKPFCNN(ref_config_ns(cfg))
    # strict load: every reference parameter covered, no stray keys
    missing, unexpected = ref.load_state_dict(sd, strict=False)
    assert not unexpected, f"unexpected keys: {unexpected[:5]}"
    assert not missing, f"missing keys: {missing[:5]}"


def test_save_checkpoint_roundtrip(tmp_path):
    cfg = _cfg()
    params, state, specs = init_kpfcnn(jax.random.key(2), cfg)
    path = str(tmp_path / "export.pth")
    save_torch_checkpoint(path, params, state, cfg, specs,
                          epoch=7, best_loss=1.25)
    params2, state2, meta = load_torch_checkpoint(path, cfg, specs)
    assert meta["epoch"] == 7
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
