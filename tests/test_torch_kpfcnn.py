"""Port vs JAX: the KPFCNN forward (K2 and K3 twins inside) on the same
sorted pyramid with the same weights, carried over by
``params_from_numpy``. Gate off: descriptors and scores at atol 1e-5.
Gate on (top-M local-max gate): the same top-250 sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d3feat_tpu.models.kpfcnn import apply_kpfcnn as j_apply, init_kpfcnn as j_init
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn
from tests.torch_port_helpers import jax_config, jax_pyramid, torch_batch_from_jax, \
    torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _both(topm, seed=3):
    _, (_, feats, _), pyr = jax_pyramid(seed)
    jcfg = jax_config(eval_gate_topm=topm)
    params, state, specs = j_init(jax.random.key(2), jcfg)
    feats_sorted = feats[pyr["band"][0]["order"]]
    jbatch = jax.tree.map(jnp.asarray, dict(pyr, features=feats_sorted))
    jout, _, _ = j_apply(params, state, jbatch, jcfg, specs, train=False, per_cloud_norm=True)
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    tout = apply_kpfcnn(model, torch_batch_from_jax(pyr, feats_sorted), per_cloud_norm=True)
    return jout, tout


def test_forward_matches_jax_gate_off():
    jout, tout = _both(topm=0)
    np.testing.assert_allclose(tout.features.numpy(), np.asarray(jout.features), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.raw_features.numpy(), np.asarray(jout.raw_features),
                               rtol=1e-4, atol=1e-5)
    assert (np.asarray(jout.scores) > 0).sum() > 50


def test_forward_matches_jax_gate_on():
    jout, tout = _both(topm=100)
    js, ts = np.asarray(jout.scores)[:, 0], tout.scores.numpy()[:, 0]
    k = min(250, int((js > 0).sum()))
    assert k > 20
    assert set(np.argsort(-js, kind="stable")[:k]) == set(np.argsort(-ts, kind="stable")[:k])
    assert np.array_equal(js > 0, ts > 0)
    np.testing.assert_allclose(tout.features.numpy(), np.asarray(jout.features), rtol=0,
                               atol=1e-5)
