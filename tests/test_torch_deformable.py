"""Port vs JAX: the deformable and modulated KPConv and its fitting
regularizer.

(a) ``models.kpconv.deformable_kpconv`` against JAX's ``kpconv(...,
    deformable=True)`` on the band pyramid's level-0 conv and pool0 lists
    (sorted positions, shadow rows, padding queries), unmodulated and
    modulated, linear influence with sum aggregation and gaussian with
    closest, with random offset weights and bias (non-zero offsets): the
    output at atol 3e-5 / rtol 1e-4 (``tests/test_band_conv.py:77-79``),
    ``min_d2`` and ``deformed_kp`` at atol 1e-6 / rtol 1e-5 beside it, and
    the gradients of ``sum(out * ct) + regularizer`` in the features,
    ``weights``, ``offset_weights`` and ``offset_bias`` against
    ``jax.grad`` at atol 5e-4 / rtol 1e-3
    (``tests/test_band_conv_grad.py:95-100``);
(b) ``p2p_fitting_regularizer``: value and gradients in ``min_d2`` and
    ``deformed_kp`` at rtol 1e-5 (the gradients that cancel to about 0 at
    1e-5 of the largest);
(c) a 2-layer deformable KPFCNN (the architecture of
    ``tests/test_reference_parity_deform.py:30-35``): the eval forward on
    JAX's band pyramid (``force_band_export``), unmodulated and modulated,
    and on JAX's original-order pyramid, descriptors and scores at atol
    1e-5; one train step given JAX's band pyramid against JAX's jitted
    ``make_train_step`` (metrics rtol 1e-5, gradients atol 5e-4 / rtol
    1e-3, as ``tests/test_torch_train_step.py`` (a)), the regularizer in
    the loss;
(d) neighbour caps wider than 64 (a deformable conv's doubled radius
    needs them): the rigid convs and the head stay on the band route, as
    JAX's, and meet its band route at atol 1e-5; the 256-entry lists hold
    K1's lists, and the kernels' K2/K4 decompositions from them meet the
    twins (f32 at the suite's tolerances, bf16 the forward and the pieces)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.losses.regularizers import p2p_fitting_regularizer as j_reg
from d3feat_tpu.models.kpconv import init_kpconv, kpconv as j_kpconv
from d3feat_tpu.models.kpfcnn import apply_kpfcnn as j_apply, init_kpfcnn as j_init
from d3feat_tpu.ops import build_pyramid as j_build, make_pyramid_spec as j_spec
from d3feat_tpu.train import init_train_state, make_train_step as j_make_train
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.config import D3FeatConfig as TConfig
from d3feat_tpu_torch.losses.regularizers import p2p_fitting_regularizer
from d3feat_tpu_torch.models.kpconv import KPConv, deformable_kpconv
from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn
from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
from d3feat_tpu_torch.train.step import TrainState, make_train_step
from tests.torch_port_helpers import jax_band_spec, jax_config, jax_pyramid, packed_pair, \
    pair_batch, torch_batch_from_jax, torch_batch_from_jax_original
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

ARCH = ["simple", "resnetb", "resnetb_deformable_strided", "resnetb_deformable",
        "nearest_upsample", "last_unary"]
FIELDS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "lr", "skipped",
          "overflow")


class JDeform(JConfig):
    def architecture(self):
        return list(ARCH)


class TDeform(TConfig):
    def architecture(self):
        return list(ARCH)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(modulated=False, **kw):
    # neighbour caps that the doubled pool0 radius does not overflow
    d = jax_config(2, modulated=modulated, **kw).to_dict()
    d["caps"]["neighbors"] = [40, 40]
    return JDeform.from_dict(d), TDeform.from_dict(d)


def _conv_case(strided, modulated, seed):
    """(q, s, inds, x, JAX params, port KPConv, extent) on the shared band
    pyramid: level 0's conv search, or the pool0 search (strided)."""
    _, _, pyr = jax_pyramid(3, 2)
    rng = np.random.default_rng(seed)
    lvl = 1 if strided else 0
    q, s = pyr["points"][lvl], pyr["points"][0]
    inds = pyr["pools"][0] if strided else pyr["neighbors"][0]
    n_valid = int(pyr["lengths"][0].sum())
    cin, cout, r = 8, 12, 0.25
    x = np.zeros((s.shape[0], cin), np.float32)
    x[:n_valid] = np.maximum(rng.normal(size=(n_valid, cin)), -0.1).astype(np.float32)
    unit = np.load("d3feat_tpu/models/dispositions/k_015_center_3D.npy").astype(np.float32)
    params = init_kpconv(jax.random.key(seed), 15, cin, cout, unit * r, deformable=True,
                         modulated=modulated)
    params = params._replace(offset_bias=jnp.asarray(
        0.3 * rng.normal(size=params.offset_bias.shape).astype(np.float32)))
    gen = torch.Generator().manual_seed(0)
    conv = KPConv(unit * r, cin, cout, gen, deformable=True, modulated=modulated)
    conv.load_state_dict(params_from_numpy(_np(params._asdict())))
    return q, s, inds, x, params, conv, r * 1.2 / 2.5


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("mode", [("linear", "sum"), ("gaussian", "closest")])
def test_deformable_kpconv_matches_jax(strided, modulated, mode):
    influence, aggregation = mode
    q, s, inds, x, params, conv, ext = _conv_case(strided, modulated, seed=1 + 2 * strided)
    kw = dict(KP_extent=ext, KP_influence=influence, aggregation_mode=aggregation)
    ct = np.random.default_rng(5).normal(size=(q.shape[0], 12)).astype(np.float32)

    def jloss(p, xx):
        out, aux = j_kpconv(jnp.asarray(q), jnp.asarray(s), jnp.asarray(inds), xx, p,
                            deformable=True, modulated=modulated, **kw)
        return jnp.sum(out * ct) + j_reg([aux], KP_extent=ext), (out, aux)

    (_, (jout, jaux)), (jg_p, jg_x) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out, aux = deformable_kpconv(_t(q), _t(s), _t(inds), xt, conv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=3e-5, rtol=1e-4)
    assert np.abs(np.asarray(jout)).max() > 1e-2
    np.testing.assert_allclose(aux.deformed_kp.detach().numpy(), np.asarray(jaux.deformed_kp),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(aux.min_d2.detach().numpy(), np.asarray(jaux.min_d2),
                               atol=1e-6, rtol=1e-5)
    moved = np.asarray(jaux.deformed_kp) - np.asarray(params.kernel_points)[None]
    assert np.abs(moved).max() > 1e-2  # the offsets are not zero

    ((out * _t(ct)).sum() + p2p_fitting_regularizer([aux], KP_extent=ext)).backward()
    assert conv.kernel_points.grad is None and conv.offset_kernel_points.grad is None
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), atol=5e-4, rtol=1e-3)
    for name in ("weights", "offset_weights", "offset_bias"):
        g = np.asarray(getattr(jg_p, name))
        assert np.abs(g).max() > 1e-3, name
        np.testing.assert_allclose(getattr(conv, name).grad.numpy(), g, atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def test_regularizer_matches_jax():
    from d3feat_tpu.models.kpconv import KPConvAux as JAux
    from d3feat_tpu_torch.models.kpconv import KPConvAux

    rng = np.random.default_rng(0)
    ext = 0.12
    auxes = [(np.abs(rng.normal(size=(30, 15))).astype(np.float32) * 0.01,
              (0.1 * rng.normal(size=(30, 15, 3))).astype(np.float32)) for _ in range(2)]

    def jf(a):
        return j_reg([JAux(m, d) for m, d in a], KP_extent=ext, repulse_extent=1.2,
                     deform_fitting_power=0.7)

    jv, jg = jax.value_and_grad(jf)([(jnp.asarray(m), jnp.asarray(d)) for m, d in auxes])
    ta = [(_t(m).requires_grad_(True), _t(d).requires_grad_(True)) for m, d in auxes]
    tv = p2p_fitting_regularizer([KPConvAux(m, d) for m, d in ta], KP_extent=ext,
                                 repulse_extent=1.2, deform_fitting_power=0.7)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    tv.backward()
    for (m, d), (jm, jd) in zip(ta, jg):
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(jm), rtol=1e-5)
        # the repulsion's gradients cancel to ~0 in places: those are held
        # at 1e-5 of the largest
        jd = np.asarray(jd)
        np.testing.assert_allclose(d.grad.numpy(), jd, rtol=1e-5, atol=1e-5 * np.abs(jd).max())


def _models(modulated):
    jcfg, tcfg = _configs(modulated)
    params, state, specs = j_init(jax.random.key(4), jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(_np(params)))
    assert sum(1 for b in model.encoder if getattr(getattr(b, "conv", None), "deformable",
                                                  False)) == 2
    return jcfg, tcfg, params, state, specs, model


def _compare_forward(jcfg, params, state, specs, model, jpyr, tbatch, feats):
    jbatch = jax.tree.map(jnp.asarray, dict(jpyr, features=feats))
    jout, _, jaux = j_apply(params, state, jbatch, jcfg, specs, train=False,
                            per_cloud_norm=True)
    tout = apply_kpfcnn(model, dict(tbatch, features=_t(feats)), per_cloud_norm=True)
    np.testing.assert_allclose(tout.features.numpy(), np.asarray(jout.features), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores), rtol=0, atol=1e-5)
    assert len(tout.auxes) == len(jaux) == 2
    for a, b in zip(tout.auxes, jaux):
        np.testing.assert_allclose(a.deformed_kp.numpy(), np.asarray(b.deformed_kp),
                                   atol=1e-5, rtol=1e-4)
    assert (np.asarray(jout.scores) > 0).sum() > 20


@pytest.mark.parametrize("modulated", [False, True])
def test_model_forward_on_band_route_matches_jax(modulated):
    jcfg, _, params, state, specs, model = _models(modulated)
    pts, feats, lens = packed_pair(3)
    jpyr = _np(j_build(jnp.asarray(pts), jnp.asarray(lens), spec=jax_band_spec(jcfg)))
    assert not jpyr["overflow"]
    _compare_forward(jcfg, params, state, specs, model, jpyr,
                     torch_batch_from_jax(jpyr, np.zeros((512, 1))),
                     feats[jpyr["band"][0]["order"]])


def test_model_forward_on_original_route_matches_jax():
    jcfg, _, params, state, specs, model = _models(False)
    jcfg.neighbor_search = "brute"
    pts, feats, lens = packed_pair(3)
    spec = j_spec(jcfg)
    assert spec.search != "pallas" and not spec.force_band_export
    jpyr = _np(j_build(jnp.asarray(pts), jnp.asarray(lens), spec=spec))
    assert not jpyr["overflow"]
    _compare_forward(jcfg, params, state, specs, model, jpyr,
                     torch_batch_from_jax_original(jpyr), feats)


def test_train_step_matches_jax():
    jcfg, tcfg = _configs()
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    spec = jax_band_spec(jcfg)
    b = pair_batch(3)
    ts2, jm = jax.jit(j_make_train(jcfg, specs, pyramid_spec=spec))(
        ts, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(0))
    jpyr = _np(j_build(jnp.asarray(b["points"]), jnp.asarray(b["lengths"]), spec=spec))
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(_np(ts.params)))
    state = TrainState(model, make_optimizer(tcfg, model))
    state, tm = make_train_step(tcfg)(state, {k: _t(v) for k, v in b.items()}, 0,
                                      pyramid=torch_batch_from_jax(jpyr, np.zeros((512, 1))))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5, err_msg=f)
    assert tm.skipped == 0.0 and tm.overflow == 0.0
    trace = params_from_numpy(_np(ts2.opt_state[-1].trace))
    params = params_from_numpy(_np(ts.params))
    names = [n for n, _ in train_tensors(model)]
    assert sorted(names) == sorted(trace)
    assert sum(n.endswith(("offset_weights", "offset_bias", "offset_kernel_points"))
               for n in names) == 6
    for name, t in train_tensors(model):
        g = trace[name] - jcfg.weight_decay * params[name]
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
    assert float(model.encoder[2].conv.offset_weights.grad.abs().max()) > 1e-4


def test_lists_wider_than_64_stay_on_the_band_route():
    """Neighbour caps above 64 (as deformable convs' doubled radii need):
    ``band_conv_eligible`` admits the rigid convs as JAX's does (its band
    route runs its Pallas kernels at K 256), the forward meets JAX's band
    route at atol 1e-5, and conv0's lists are 256 entries wide and hold
    K1's lists of up to 256 rows (more than 128 here), from which the kernels' K2 and K4 decompositions
    (``band_conv_from_lists``, ``band_conv_bwd_from_lists``, f32 and bf16
    panels) meet the twins: the f32 output at atol 3e-5 / rtol 1e-4 and
    its gradients at atol 5e-4 / rtol 1e-3 (``tests/test_band_conv.py``,
    ``tests/test_band_conv_grad.py``); the bf16 pieces by ballot equal
    the serial scan."""
    from d3feat_tpu.models.blocks import band_conv_eligible as j_eligible
    from d3feat_tpu_torch.models.blocks import band_conv_eligible, search_inputs
    from d3feat_tpu_torch.ops.band_conv import band_conv_bwd_plain, band_conv_plain
    from d3feat_tpu_torch.ops.band_lists import LCAP, band_lists
    from tests.torch_port_helpers import (band_conv_bwd_from_lists, band_conv_from_lists,
                                          piece_starts_ballot, piece_starts_serial)

    d = jax_config(2).to_dict()
    d["caps"]["neighbors"] = [256, 256]
    d["conv_radius"] *= 4.0  # lists of more than 128 rows on this 220-point cloud
    jcfg, tcfg = JConfig.from_dict(d), TConfig.from_dict(d)
    params, state, specs = j_init(jax.random.key(5), jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(_np(params)))
    pts, feats, lens = packed_pair(3)
    jpyr = _np(j_build(jnp.asarray(pts), jnp.asarray(lens), spec=jax_band_spec(jcfg)))
    assert not jpyr["overflow"] and jpyr["neighbors"][0].shape[1] == 256 > LCAP
    tbatch = torch_batch_from_jax(jpyr, np.zeros((512, 1)))
    rigid = [s for s in specs.encoder if s.kind in ("simple", "resnetb")]
    assert [band_conv_eligible(s, tbatch, tcfg) for s in rigid] == \
        [j_eligible(s, jpyr, jcfg, False) for s in rigid] == [True] * len(rigid)
    jbatch = jax.tree.map(jnp.asarray, dict(jpyr, features=feats[jpyr["band"][0]["order"]]))
    jout, _, _ = j_apply(params, state, jbatch, jcfg, specs, train=False, per_cloud_norm=True)
    tout = apply_kpfcnn(model, dict(tbatch, features=_t(feats[jpyr["band"][0]["order"]])),
                        per_cloud_norm=True)
    np.testing.assert_allclose(tout.features.numpy(), np.asarray(jout.features), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores), rtol=0, atol=1e-5)

    r0 = jcfg.first_subsampling_dl * jcfg.conv_radius
    port = search_inputs(tbatch, tcfg, 0, False, r0, impl="plain")
    lists = band_lists(**{k: port[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts",
                                                "wends", "query_tile")}, width=256)
    n_q, n_s = jpyr["points"][0].shape[0], jpyr["points"][0].shape[0]
    lcnt = lists.lcnt.numpy()
    assert lists.width == 4 * LCAP and lcnt.max() > 2 * LCAP  # the comparison is not vacuous
    for q in range(n_q):
        ref = jpyr["neighbors"][0][q]
        assert set(lists.lpos[q, :lcnt[q]].tolist()) == set(ref[ref < n_s].tolist()), q
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(port["s_rows"].shape[0], 16)).astype(np.float32))
    x[n_s:] = 0.0
    w = torch.from_numpy(rng.normal(size=(15, 16, 16)).astype(np.float32) * 0.1)
    kp = model.encoder[0].conv.kernel_points
    ext = r0 * tcfg.KP_extent / tcfg.conv_radius
    kw = {k: port[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts", "wends")}
    out, den = band_conv_plain(x=x, weights=w, kernel_points=kp, extent=ext,
                               query_tile=port["query_tile"], **kw)
    lout, lden, _ = band_conv_from_lists(lists, port["q_rows"], port["s_rows"], x, w, kp, ext)
    assert torch.equal(lden, den)
    np.testing.assert_allclose(lout.numpy(), out.numpy(), atol=3e-5, rtol=1e-4)
    gs = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32)) / den[:, None]
    dx, dw = band_conv_bwd_plain(x=x, weights=w, kernel_points=kp, gs=gs, extent=ext,
                                 query_tile=port["query_tile"], **kw)
    ldx, ldw = band_conv_bwd_from_lists(lists, port["q_rows"], port["s_rows"], x, w, kp, gs,
                                        ext)
    np.testing.assert_allclose(ldx.numpy(), dx.numpy(), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(ldw.numpy(), dw.numpy(), atol=5e-4, rtol=1e-3)
    chunk = port["chunk"]
    bout, _ = band_conv_plain(x=x, weights=w, kernel_points=kp, extent=ext,
                              query_tile=port["query_tile"], panel_dtype="bfloat16",
                              chunk=chunk, **kw)
    blout, _, _ = band_conv_from_lists(lists, port["q_rows"], port["s_rows"], x, w, kp, ext,
                                       chunk, port["starts"], port["query_tile"])
    np.testing.assert_allclose(blout.numpy(), bout.numpy(), atol=3e-5, rtol=1e-4)
    ws = port["starts"].long().repeat_interleave(port["query_tile"]).numpy()
    args = (lists.lpos.numpy(), lcnt, ws, 16)
    assert np.array_equal(piece_starts_ballot(*args), piece_starts_serial(*args))
