"""Port vs JAX: KPCNN, the classification network (``models/kpcnn.py``),
and the block kinds it adds (``max_pool``, ``global_average``), at 2
layers (5 classes) on the shared test pair with random input features.

(a) the specs equal JAX's ``make_kpcnn_specs`` (default and given
    architectures);
(b) the per-cloud logits against ``apply_kpcnn`` on JAX's band pyramid
    (``force_band_export``: K2 at the rigid convs) and on its
    original-order pyramid, at atol 1e-5; ``kpcnn_loss`` and
    ``kpcnn_accuracy`` at rtol 1e-5, and the gradients of the loss against
    ``jax.grad`` at atol 5e-4 / rtol 1e-3 (``tests/test_band_conv_grad.py``);
(c) with batch norm (train mode): logits, the new running statistics
    (atol 1e-6) and the loss gradients (atol/rtol 5e-3: the head's norm over
    two rows amplifies float32 noise, see the test); with a deformable
    strided block and block: logits, the loss with its regularizer and its
    gradients;
(d) the ``max_pool`` and ``global_average`` blocks alone against JAX's
    ``apply_block`` (atol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.models import kpcnn as J
from d3feat_tpu.models.blocks import BlockSpec as JSpec, apply_block
from d3feat_tpu.ops import build_pyramid as j_build, make_pyramid_spec as j_spec
from d3feat_tpu_torch.compat.weights import params_from_numpy, state_from_numpy
from d3feat_tpu_torch.config import D3FeatConfig as TConfig
from d3feat_tpu_torch.models import kpcnn as P
from d3feat_tpu_torch.models.blocks import BlockSpec, make_block
from tests.torch_port_helpers import jax_band_spec, jax_config, packed_pair, \
    torch_batch_from_jax, torch_batch_from_jax_original
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LABELS = np.array([1, 3])
DEFORM_ARCH = ["simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
               "global_average"]


class JDeform(JConfig):  # the pyramid widens pool0 for the deformable strided block
    def architecture(self):
        return ["simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
                "nearest_upsample", "last_unary"]


class TDeform(TConfig):
    def architecture(self):
        return JDeform.architecture(self)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(deform=False, **kw):
    d = jax_config(2, num_classes=5, **kw).to_dict()
    if deform:
        d["caps"]["neighbors"] = [40, 40]
        return JDeform.from_dict(d), TDeform.from_dict(d)
    return JConfig.from_dict(d), TConfig.from_dict(d)


def _batches(jcfg, route):
    """(JAX batch, port batch) on one pyramid of JAX's, random features."""
    pts, feats, lens = packed_pair(3)
    feats = feats * np.random.default_rng(1).uniform(0.5, 1.5, feats.shape).astype(np.float32)
    if route == "band":
        pyr = _np(j_build(jnp.asarray(pts), jnp.asarray(lens), spec=jax_band_spec(jcfg)))
        feats = feats[pyr["band"][0]["order"]]
        tb = torch_batch_from_jax(pyr, feats)
    else:
        jcfg.neighbor_search = "brute"
        pyr = _np(j_build(jnp.asarray(pts), jnp.asarray(lens), spec=j_spec(jcfg)))
        tb = dict(torch_batch_from_jax_original(pyr), features=_t(feats))
    assert not pyr["overflow"]
    return jax.tree.map(jnp.asarray, dict(pyr, features=feats)), tb


def _models(jcfg, tcfg, arch=None, key=0):
    jspecs = J.make_kpcnn_specs(jcfg, arch)
    params, state, _ = J.init_kpcnn(jax.random.key(key), jcfg, jspecs)
    model = P.init_kpcnn(tcfg, device="cpu", specs=P.make_kpcnn_specs(tcfg, arch))
    sd = params_from_numpy(_np(params))
    if tcfg.use_batch_norm:
        sd.update(state_from_numpy(_np(state), model))
    model.load_state_dict(sd)
    return params, state, jspecs, model


def _jloss(jcfg, jspecs, state, jbatch, train):
    def f(p):
        logits, new_state, auxes = J.apply_kpcnn(p, state, jbatch, jcfg, jspecs, train=train)
        loss, ce = J.kpcnn_loss(logits, jnp.asarray(LABELS), auxes, jcfg)
        return loss, (logits, new_state, ce, auxes)
    return f


def _check_grads(model, jgrads, tol=(5e-4, 1e-3)):
    jg = params_from_numpy(_np(jgrads))
    names = [n for n, p in model.named_parameters()]
    assert sorted(names) == sorted(k for k in jg if not k.endswith("kernel_points"))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[n].numpy(), atol=tol[0], rtol=tol[1],
                                   err_msg=n)
    assert max(float(jg[n].abs().max()) for n in names) > 1e-2


@pytest.mark.parametrize("num_layers", [2, 3, 5])
def test_specs_match_jax(num_layers):
    jcfg = jax_config(num_layers)
    tcfg = TConfig.from_dict(jcfg.to_dict())
    assert P.classification_architecture(num_layers) == J.classification_architecture(num_layers)
    for arch in (None, DEFORM_ARCH, ["simple", "resnetb", "max_pool", "resnetb",
                                     "global_average"]):
        js, ts = J.make_kpcnn_specs(jcfg, arch), P.make_kpcnn_specs(tcfg, arch)
        assert ts.head_in_dim == js.head_in_dim
        assert [b.__dict__ for b in ts.blocks] == [b.__dict__ for b in js.blocks]


@pytest.mark.parametrize("route", ["band", "original"])
def test_logits_loss_and_gradients_match_jax(route):
    jcfg, tcfg = _configs()
    jbatch, tbatch = _batches(jcfg, route)
    params, state, jspecs, model = _models(jcfg, tcfg)
    (jl, (jlogits, _, jce, jaux)), jg = jax.value_and_grad(
        _jloss(jcfg, jspecs, state, jbatch, True), has_aux=True)(params)
    assert jaux == []

    with torch.no_grad():
        ev = P.apply_kpcnn(model, tbatch)
    jev, _, _ = J.apply_kpcnn(params, state, jbatch, jcfg, jspecs)
    assert ev.logits.shape == (2, 5) and ev.auxes == ()
    np.testing.assert_allclose(ev.logits.numpy(), np.asarray(jev), rtol=0, atol=1e-5)

    out = P.apply_kpcnn(model, tbatch, train=True)
    loss, ce = P.kpcnn_loss(out.logits, _t(LABELS), out.auxes, tcfg)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=1e-5)
    for labels in (LABELS, np.asarray(jnp.argmax(jlogits, -1)), np.array([0, 4])):
        assert float(P.kpcnn_accuracy(out.logits, _t(labels))) == float(
            J.kpcnn_accuracy(jlogits, jnp.asarray(labels)))
    loss.backward()
    _check_grads(model, jg)


def test_batch_norm_kpcnn_matches_jax():
    jcfg, tcfg = _configs(use_batch_norm=True)
    jbatch, tbatch = _batches(jcfg, "band")
    params, state, jspecs, model = _models(jcfg, tcfg, key=2)
    (jl, (jlogits, jstate, _, _)), jg = jax.value_and_grad(
        _jloss(jcfg, jspecs, state, jbatch, True), has_aux=True)(params)
    out = P.apply_kpcnn(model, tbatch, train=True)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    loss, _ = P.kpcnn_loss(out.logits, _t(LABELS), out.auxes, tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    # the head's norm runs over the 2 clouds' rows, and some of its 1024
    # channels differ by ~1e-7 between them (variance far below its 1e-5
    # epsilon): its backward amplifies the blocks' float32 noise ~300
    # times, so the blocks' gradients are held at the whole-network
    # tolerance of tests/test_torch_train_step.py (b)
    _check_grads(model, jg, tol=(5e-3, 5e-3))
    want = state_from_numpy(_np(jstate), model)
    assert "head_mlp.norm.mean" in want and len(want) == 2 * 17
    bufs = dict(model.named_buffers())
    for n, v in want.items():
        np.testing.assert_allclose(bufs[n].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=n)


def test_deformable_kpcnn_matches_jax():
    jcfg, tcfg = _configs(deform=True)
    jbatch, tbatch = _batches(jcfg, "band")
    params, state, jspecs, model = _models(jcfg, tcfg, arch=DEFORM_ARCH, key=3)
    (jl, (jlogits, _, jce, jaux)), jg = jax.value_and_grad(
        _jloss(jcfg, jspecs, state, jbatch, True), has_aux=True)(params)
    out = P.apply_kpcnn(model, tbatch, train=True)
    assert len(out.auxes) == len(jaux) == 2
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    loss, ce = P.kpcnn_loss(out.logits, _t(LABELS), out.auxes, tcfg)
    assert float(loss.detach()) > float(ce.detach())  # the regularizer is in
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    loss.backward()
    _check_grads(model, jg)


@pytest.mark.parametrize("kind", ["max_pool", "global_average"])
def test_pooling_blocks_match_jax(kind):
    d = jax_config(3).to_dict()
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    jbatch, tbatch = _batches(jcfg, "band")
    rng = np.random.default_rng(4)
    layer = 0 if kind == "max_pool" else 2
    rows = jbatch["points"][layer].shape[0]
    x = rng.normal(size=(rows, 6)).astype(np.float32)
    kw = dict(name=kind, kind=kind, layer=layer, in_dim=6, out_dim=6, radius=0.25)
    jy, _, _ = apply_block({}, {}, JSpec(**kw), jnp.asarray(x), jbatch, jcfg, train=False)
    block = make_block(BlockSpec(**kw), tcfg, None, torch.Generator())
    ty, aux = block(_t(x), tbatch)
    assert aux is None and ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-6)
