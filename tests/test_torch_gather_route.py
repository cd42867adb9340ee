"""Port vs JAX: the gather route, end to end at 3 layers on the shared
test pair.

(a) the original-order pyramid (``neighbor_search`` ``'banded'``,
    ``'brute'``, ``'grid'``) against JAX's ``build_pyramid`` on its XLA
    route: level 0's points and lists, every level's lengths and masks and
    the overflow flags bit for bit; the deeper levels' points within 1e-6
    (the subsampler's barycentre ulps, ROADMAP Queue 3 "Not faults"), and
    every deeper search, run by the port on JAX's own level points, bit for
    bit. ``'banded'`` runs at a level-0 capacity above 4096 rows, where the
    reference takes the banded search; below it takes the brute one;
(b) on that route (``'banded'``), the forward through ``make_extract_step``
    and one ``make_train_step`` against JAX's jitted steps: descriptors and
    scores at atol 1e-5; the step given JAX's pyramid at
    ``tests/test_torch_train_step.py``'s tolerances for a given pyramid
    (loss and metrics rtol 1e-5, gradients atol 5e-4 / rtol 1e-3), and from
    raw points at its tolerances for a pyramid of its own (loss rtol 1e-3,
    gradients atol/rtol 5e-3); ``FeatureExtractor`` follows the route;
(c) the mixed route (the band pyramid with some convs on the gather
    KPConv: ``bandconv_max_layer=0``, and ``KP_influence='gaussian'``,
    which leaves every conv to it) against JAX with ``force_band_export``:
    one train step given JAX's pyramid and the extraction step."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.config import PyramidCaps as JCaps
from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
from d3feat_tpu.ops import build_pyramid as j_build, make_pyramid_spec as j_spec
from d3feat_tpu.train import init_train_state, make_train_step as j_make_train
from d3feat_tpu.train.step import make_extract_step as j_make_extract
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec, original_search
from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step
from tests.torch_port_helpers import jax_band_spec, jax_config, packed_pair, pair_batch, \
    torch_batch_from_jax, torch_batch_from_jax_original, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3
FIELDS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "lr", "skipped",
          "overflow")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _route_config(search, **kw):
    jcfg = jax_config(LAYERS, neighbor_search=search, **kw)
    if search == "banded":  # a level-0 capacity where the reference bands
        jcfg.caps = JCaps(points=(4608, 256, 128), neighbors=jcfg.caps.neighbors, corr=8)
    return jcfg


def _jax_original_pyramid(jcfg, pts, lens):
    spec = j_spec(jcfg)
    assert spec.search != "pallas" and not spec.force_band_export
    return jax.tree.map(np.asarray, j_build(jnp.asarray(pts), jnp.asarray(lens), spec=spec))


@pytest.mark.parametrize("search", ["banded", "brute", "grid"])
def test_original_pyramid_matches_jax(search):
    jcfg = _route_config(search)
    pts, _, lens = packed_pair(3, cap=jcfg.caps.points[0])
    jp = _jax_original_pyramid(jcfg, pts, lens)
    spec = make_pyramid_spec(torch_config(jcfg))
    assert spec.search == search
    tp = build_pyramid(_t(pts), _t(lens), spec=spec)
    assert tp["band"] == {} and tp["sel_thr"] == {}
    assert sorted(tp["overflow_by"]) == sorted(jp["overflow_by"])
    for name, flag in jp["overflow_by"].items():
        assert bool(tp["overflow_by"][name]) == bool(flag), name
    assert bool(tp["overflow"]) == bool(jp["overflow"])
    assert np.array_equal(tp["points"][0].numpy(), jp["points"][0])
    assert np.array_equal(tp["neighbors"][0].numpy(), jp["neighbors"][0])
    for l in range(LAYERS):
        assert np.array_equal(tp["lengths"][l].numpy(), jp["lengths"][l]), l
        assert np.array_equal(tp["masks"][l].numpy(), jp["masks"][l]), l
        np.testing.assert_allclose(tp["points"][l].numpy(), jp["points"][l], rtol=0, atol=1e-6)
    r0 = jcfg.first_subsampling_dl * jcfg.conv_radius
    p, n = [_t(a) for a in jp["points"]], [_t(a) for a in jp["lengths"]]
    k = spec.neighbor_caps
    for l in range(LAYERS):
        r = r0 * 2.0**l
        if l:
            got, _ = original_search(p[l], p[l], n[l], n[l], r, k[l], spec)
            assert np.array_equal(got.numpy(), jp["neighbors"][l]), l
        if l + 1 < LAYERS:
            got, _ = original_search(p[l + 1], p[l], n[l + 1], n[l], r, k[l], spec)
            assert np.array_equal(got.numpy(), jp["pools"][l]), l
            got, _ = original_search(p[l], p[l + 1], n[l], n[l + 1], 2.0 * r, 1, spec)
            assert np.array_equal(got.numpy(), jp["upsamples"][l]), l


@pytest.fixture(scope="module")
def banded_steps():
    jcfg = jax_config(LAYERS, neighbor_search="banded")
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    spec = j_spec(jcfg)
    return (jcfg, ts, specs, jax.jit(j_make_train(jcfg, specs, pyramid_spec=spec)),
            jax.jit(j_make_extract(jcfg, specs, pyramid_spec=spec)))


def _port_state(jcfg, params):
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    return tcfg, TrainState(model, make_optimizer(tcfg, model))


def _jax_grads(jcfg, ts, ts2):
    trace = params_from_numpy(jax.tree.map(np.asarray, ts2.opt_state[-1].trace))
    params = params_from_numpy(jax.tree.map(np.asarray, ts.params))
    return {k: trace[k] - jcfg.weight_decay * params[k] for k in trace}


def _check_step(jcfg, ts, jstep, b, pyramid, tight):
    ts2, jm = jstep(ts, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(0))
    tcfg, state = _port_state(jcfg, ts.params)
    state, tm = make_train_step(tcfg)(state, {k: _t(v) for k, v in b.items()}, 0,
                                      pyramid=pyramid)
    assert tm.skipped == float(jm.skipped) == 0.0 and state.step == 1
    assert tm.overflow == float(jm.overflow) == 0.0
    jgrads = _jax_grads(jcfg, ts, ts2)
    names = [n for n, _ in train_tensors(state.model)]
    assert sorted(names) == sorted(jgrads)
    if tight:
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5,
                                       err_msg=f)
        for name, t in train_tensors(state.model):
            np.testing.assert_allclose(t.grad.numpy(), jgrads[name].numpy(), atol=5e-4,
                                       rtol=1e-3, err_msg=name)
    else:
        np.testing.assert_allclose(tm.loss, float(jm.loss), rtol=1e-3)
        flat_t = np.concatenate([t.grad.numpy().ravel() for _, t in train_tensors(state.model)])
        flat_j = np.concatenate([jgrads[n].numpy().ravel() for n in names])
        np.testing.assert_allclose(flat_t, flat_j, atol=5e-3, rtol=5e-3)
    assert max(float(jgrads[n].abs().max()) for n in names) > 1e-2


def test_train_step_given_jax_pyramid_matches_jax(banded_steps):
    jcfg, ts, _, jstep, _ = banded_steps
    b = pair_batch(3)
    pyr = _jax_original_pyramid(jcfg, b["points"], b["lengths"])
    _check_step(jcfg, ts, jstep, b, torch_batch_from_jax_original(pyr), tight=True)


@pytest.mark.parametrize("seed", [3, 5])
def test_train_step_from_raw_points_matches_jax(banded_steps, seed):
    jcfg, ts, _, jstep, _ = banded_steps
    _check_step(jcfg, ts, jstep, pair_batch(seed), None, tight=False)


def test_extract_step_matches_jax(banded_steps):
    jcfg, ts, _, _, jextract = banded_steps
    pts, feats, lens = packed_pair(5)
    jf, js, jov = jextract(ts.params, ts.model_state,
                           {"points": jnp.asarray(pts), "features": jnp.asarray(feats),
                            "lengths": jnp.asarray(lens)})
    tcfg, state = _port_state(jcfg, ts.params)
    batch = {"points": _t(pts), "features": _t(feats), "lengths": _t(lens)}
    tf, tsc, tov = make_extract_step(tcfg)(state.model, batch)
    assert bool(tov) == bool(jov) is False
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    n = int(lens.sum())
    np.testing.assert_allclose(np.linalg.norm(tf.numpy()[:n], axis=1), 1.0, atol=1e-5)
    assert float(np.abs(np.asarray(js)).max()) > 0


def test_feature_extractor_follows_the_route(banded_steps):
    """``FeatureExtractor`` on the gather route against JAX's on its XLA
    route: one fragment in the 256-row bucket, descriptors and scores at
    atol 1e-5."""
    from d3feat_tpu.eval.extract import FeatureExtractor as JFeatureExtractor
    from d3feat_tpu_torch.eval.extract import FeatureExtractor

    jcfg, ts, _, _, _ = banded_steps
    tcfg, state = _port_state(jcfg, ts.params)
    pts, _, lens = packed_pair(5)
    frag = pts[:int(lens[0])]
    jf, js = JFeatureExtractor(jcfg, ts.params, ts.model_state, buckets=(256,)).extract(frag)
    tf, tsc = FeatureExtractor(tcfg, state.model, buckets=(256,), device="cpu").extract(frag)
    assert tf.shape == (len(frag), tcfg.output_dim) and tsc.shape == (len(frag),)
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsc, np.asarray(js), rtol=0, atol=1e-5)


MIXED = {"max_layer_0": dict(bandconv_max_layer=0), "gaussian": dict(KP_influence="gaussian")}


@pytest.mark.parametrize("mode", sorted(MIXED))
def test_mixed_route_matches_jax(mode):
    jcfg = jax_config(LAYERS, **MIXED[mode])
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    spec = jax_band_spec(jcfg)
    b = pair_batch(3)
    pyr = jax.tree.map(np.asarray, j_build(jnp.asarray(b["points"]), jnp.asarray(b["lengths"]),
                                           spec=spec))
    jstep = jax.jit(j_make_train(jcfg, specs, pyramid_spec=spec))
    _check_step(jcfg, ts, jstep, b, torch_batch_from_jax(pyr, np.zeros((512, 1))), tight=True)

    params, state, specs = j_init(jax.random.key(5), jcfg)
    pts, feats, lens = packed_pair(5)
    jf, js, _ = jax.jit(j_make_extract(jcfg, specs, pyramid_spec=spec))(
        params, state, {"points": jnp.asarray(pts), "features": jnp.asarray(feats),
                        "lengths": jnp.asarray(lens)})
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    tf, tsc, _ = make_extract_step(tcfg)(model, {"points": _t(pts), "features": _t(feats),
                                                 "lengths": _t(lens)})
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0, atol=1e-5)
