"""List mode (no thresholds): K2's and K4's band route when a search has no
``sel_thr``, and the gather head, port vs JAX (Pallas in interpret mode).

(a) the list stage's twin (``band_lists_given_plain``) on shadows,
    duplicates and positions outside the window, against a loop;
(b) K2's list-mode twin (``band_conv`` with ``thr=None``, ``neighb=``)
    against JAX ``band_conv`` with ``thr=None``: f32 at atol 3e-5 / rtol
    1e-4 (``tests/test_band_conv.py:77-79``), density exact; bf16 panels at
    relative L2 1e-2 and ten times nearer JAX's bf16 than the f32 twin
    (``tests/test_torch_bf16.py``'s bounds); on the standalone level of
    ``test_band_conv_threshold_matches_list_mode`` and on the pyramid's
    strided pool0 search (its arguments from ``search_inputs`` of a batch
    without ``sel_thr``);
(c) K4's list-mode twin through ``BandConvFn`` against the VJP of JAX
    ``band_conv_ad`` with ``thr=None``: dx and dW at atol 5e-4 / rtol 1e-3
    (``tests/test_band_conv_grad.py:95-100``), bf16 as in (b);
(d) the kernels' list-mode route emulated from the list stage's lists
    (``tests/torch_port_helpers.py``) against the twins: f32 at (b)'s and
    (c)'s tolerances, bf16 within relative L2 1e-4, density exact;
(e) the 3-layer forward on a ``force_band_export`` pyramid with
    ``sel_thr`` emptied against JAX's (list mode and the gather head) at
    atol 1e-5, and one train step on it against JAX's jitted train step
    whose pyramid drops ``sel_thr`` (loss and metrics rtol 1e-5, gradients
    atol 5e-4 / rtol 1e-3, ``test_torch_train_step.py``'s (a));
(f) ``bandhead_train=False``: the train head takes the gather route in
    both stacks (scores rtol 1e-6, gradients ``test_torch_head_grad.py``'s
    tolerance), and the memo keeps both modes' arguments apart."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.kernel_points import load_kernels as j_load_kernels
from d3feat_tpu.ops.neighbors import SortedLevel, make_level_frame, radius_neighbors_sorted
from d3feat_tpu.ops.pallas.band_conv import band_conv as j_band_conv, band_conv_ad
from d3feat_tpu_torch.models.blocks import band_query_tiles, search_inputs
from d3feat_tpu_torch.ops.band_conv import BandConvFn, band_conv
from d3feat_tpu_torch.ops.band_lists import (LCAP, LMAX, band_lists_given,
                                              band_lists_given_plain)
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import band_conv_bwd_from_lists, band_conv_from_lists, \
    jax_band_spec, jax_config, jax_pyramid, pair_batch, torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

F32_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
BOUND = 1e-2       # bf16 panels: relative L2 (tests/test_band_conv.py:193-195)
TWIN_BOUND = 1e-4  # the kernels' bf16 route against the bf16 twins
LAYERS = 3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX inputs, port keyword arguments of ``band_conv``, x [n_x, Cin],
    W, kernel points, cotangent [n_q, Cout], the shadow position)."""
    if name == "standalone":  # test_band_conv.py::test_band_conv_threshold_matches_list_mode
        rng = np.random.default_rng(3)
        n0, n1, cap = 230, 210, 512
        pts = np.concatenate([
            rng.uniform(0, 1, size=(n0, 3)) * np.array([3.0, 1.0, 0.5]),
            rng.uniform(0, 1, size=(n1, 3)) * np.array([0.7, 2.4, 0.8])]).astype(np.float32)
        padded = np.full((cap, 3), 1.0e6, np.float32)
        padded[: len(pts)] = pts
        lens = jnp.asarray(np.array([n0, n1], np.int32))
        r, k, cin, cout, tile, band = 0.4, 12, 8, 16, 64, 512
        axis, origin = make_level_frame(jnp.asarray(padded), lens, 2)
        lvl = SortedLevel(jnp.asarray(padded), lens, 2, axis, origin, band_pad=512)
        neighb, ov = radius_neighbors_sorted(lvl, lvl, r, max_k=k, query_tile=tile,
                                             band_cap=band, interpret=True, raw_positions=True)
        assert not bool(ov)
        qb = {"q_rows": _t(np.asarray(lvl.q_packed)[:4].T), "key_sorted": _t(lvl.key_sorted)}
        sb = {"key_sorted": _t(lvl.key_sorted)}
        q_rows, starts, ends, _, _ = band_query_tiles(qb, sb, 2, r, tile, cap, None, None)
        starts, wends = band_windows(starts, ends, band)
        neighb_sorted = np.asarray(neighb).T.astype(np.int32)
        port = dict(q_rows=q_rows, thr=None, ptie=None, neighb=_t(neighb_sorted),
                    s_rows=_t(np.asarray(lvl.s_packed)[:, :4]), starts=starts, wends=wends,
                    query_tile=tile, chunk=256, extent=r * 2.0 / 2.5)
        s_packed, n_x, n_q, shadow = np.asarray(lvl.s_packed), cap, cap, cap
        x = rng.normal(size=(cap, cin)).astype(np.float32)
        x[len(pts):] = 0.0
        x = x[np.asarray(lvl.order)]
    else:  # the strided pool0 conv of the shared pyramid, through search_inputs
        jcfg, _, pyr = jax_pyramid(3)
        rng = np.random.default_rng(11)
        r = jcfg.first_subsampling_dl * jcfg.conv_radius
        cin, cout = 8, 8
        batch = dict(torch_batch_from_jax(pyr, np.zeros((512, 1))), sel_thr={})
        port = search_inputs(batch, torch_config(jcfg), 0, True, r, impl="plain")
        assert port["thr"] is None and "lists" not in port
        port["extent"] = r * 2.0 / 2.5
        n_x, n_q = pyr["points"][0].shape[0], pyr["points"][1].shape[0]
        band = level_band_cap(n_x, 2, 0.1, tile=128, ratio=-(-n_x // n_q))
        neighb_sorted = port["neighb"].numpy()
        s_packed, shadow, tile = pyr["band"][0]["s_packed"], n_x, 128
        n_valid = int(pyr["lengths"][0].sum())
        x = np.zeros((n_x, cin), np.float32)
        x[:n_valid] = rng.normal(size=(n_valid, cin))
        x[:n_valid:5] = np.abs(x[:n_valid:5])
    w = (rng.normal(size=(15, cin, cout)) * 0.3).astype(np.float32)
    kp = j_load_kernels(r, 15, deterministic=True).astype(np.float32)
    cot = rng.normal(size=(n_q, cout)).astype(np.float32)
    qp = np.zeros((8, port["q_rows"].shape[0]), np.float32)
    qp[:4] = port["q_rows"].numpy().T
    # the port's windows are the TPU kernel's: starts floored to 8, ends at whole chunks
    jx = dict(q_packed=jnp.asarray(qp), neighb=jnp.asarray(neighb_sorted),
              s_packed=jnp.asarray(s_packed), starts=jnp.asarray(port["starts"].numpy()),
              ends=jnp.asarray(port["wends"].numpy()), band=band, tile=tile,
              extent=port["extent"])
    return jx, port, x, w, kp, cot, shadow


def _pad(x, n_rows):
    return torch.cat([x, x.new_zeros((n_rows - x.shape[0], x.shape[1]))])


@functools.lru_cache(maxsize=None)
def _jax_out(name, panel):
    jx, port, x, w, kp, _, _ = _case(name)
    out, den = j_band_conv(jx["q_packed"], jx["neighb"], jx["s_packed"],
                           jnp.asarray(_pad(torch.from_numpy(x), jx["s_packed"].shape[0])),
                           jnp.asarray(w), jnp.asarray(kp), jx["starts"],
                           jnp.float32(jx["extent"]), jx["ends"], band_cap=jx["band"],
                           query_tile=jx["tile"], interpret=True, panel_dtype=panel)
    return np.asarray(out), np.asarray(den)[0]


@functools.lru_cache(maxsize=None)
def _jax_grads(name, panel):
    jx, _, x, w, kp, cot, _ = _case(name)
    n_rows = jx["s_packed"].shape[0]

    def loss(x_in, w_in):
        x_pad = jnp.concatenate([x_in, jnp.zeros((n_rows - x_in.shape[0], x_in.shape[1]))])
        out = band_conv_ad(jx["band"], jx["tile"], True, panel, jx["q_packed"], jx["neighb"],
                           jx["s_packed"], x_pad, w_in, jnp.asarray(kp), jx["starts"],
                           jnp.float32(jx["extent"]), jx["ends"])
        return jnp.sum(out[: cot.shape[0]] * cot)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(jdx), np.asarray(jdw)


def _twin(name, panel):
    _, port, x, w, kp, _, _ = _case(name)
    return band_conv(x=_pad(torch.from_numpy(x), port["s_rows"].shape[0]),
                     weights=torch.from_numpy(w), kernel_points=torch.from_numpy(kp),
                     panel_dtype=panel, **port)


def _twin_grads(name, panel):
    _, port, x, w, kp, cot, _ = _case(name)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = BandConvFn.apply(_pad(xt, port["s_rows"].shape[0]), wt, torch.from_numpy(kp),
                           dict(port, panel_dtype=panel), "plain")
    loss = (out[: cot.shape[0]] * torch.from_numpy(cot)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (xt, wt))]


def _given_lists(name):
    _, port, _, _, _, _, shadow = _case(name)
    return band_lists_given(port["neighb"], port["starts"], port["wends"],
                            query_tile=port["query_tile"], n_rows=shadow)


# --- (a) the list stage ---


def test_list_stage_twin_keeps_listed_positions_in_the_window():
    """Shadows (position n_rows), a position listed twice, positions
    outside the tile's window and a zero pad row inside it (>= n_rows),
    against a loop over the TPU kernel's rule."""
    rng = np.random.default_rng(0)
    tile, k, n_rows = 32, 9, 90
    starts = torch.tensor([0, 40], dtype=torch.int32)
    wends = torch.tensor([64, 100], dtype=torch.int32)
    neighb = rng.integers(0, 96, size=(k, 2 * tile)).astype(np.int32)
    neighb[-3:, ::3] = n_rows                         # shadows
    neighb[1, 5] = neighb[4, 5]                       # a repeated position
    neighb[0, 40] = 95                                # in the window, past n_rows: a zero pad
    neighb[2, 41] = 10                                # before the second tile's window
    neighb[3, 7] = 70                                 # past the first tile's window
    lists = band_lists_given_plain(torch.from_numpy(neighb), starts, wends, query_tile=tile,
                                   n_rows=n_rows)
    assert lists.mode == "list" and lists.ld2 is None and lists.lpos.shape == (2 * tile, LCAP)
    for q in range(2 * tile):
        ws, we = int(starts[q // tile]), min(int(wends[q // tile]), n_rows)
        want = sorted(int(p) for p in neighb[:, q] if ws <= p < we)
        n = int(lists.lcnt[q])
        assert lists.lpos[q, :n].tolist() == want, q
        assert (lists.lpos[q, n:] == -1).all()
    assert lists.lpos[5].tolist().count(int(neighb[1, 5])) >= 2
    assert 95 not in lists.lpos[40].tolist() and 10 not in lists.lpos[41].tolist()
    assert 70 not in lists.lpos[7].tolist()
    wide = band_lists_given_plain(torch.zeros((LCAP + 1, tile), dtype=torch.int32), starts[:1],
                                  wends[:1], query_tile=tile, n_rows=n_rows)
    assert wide.width == 2 * LCAP and (wide.lcnt == LCAP + 1).all()
    with pytest.raises(ValueError, match="LMAX"):
        band_lists_given_plain(torch.zeros((LMAX + 1, tile), dtype=torch.int32), starts[:1],
                               wends[:1], query_tile=tile, n_rows=n_rows)
    with pytest.raises(ValueError, match="CUDA"):
        band_lists_given(torch.from_numpy(neighb), starts, wends, query_tile=tile,
                         n_rows=n_rows, impl="kernel")


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_list_stage_density_is_the_tpu_selection(name):
    """The lists' entries with a positive feature row count exactly as the
    TPU kernel's density (JAX's ``den``): repeats counted, shadows and rows
    outside the windows never."""
    _, port, x, _, _, _, _ = _case(name)
    lists = _given_lists(name)
    xs = _pad(torch.from_numpy(x), port["s_rows"].shape[0])
    act = (xs.sum(1) > 0)[lists.lpos.clamp(min=0).long()] & (lists.lpos >= 0)
    np.testing.assert_array_equal(act.sum(1).float().clamp(min=1.0).numpy(),
                                  _jax_out(name, "float32")[1])


# --- (b), (c): the twins against JAX's list mode ---


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_k2_list_twin_matches_jax(name):
    jout, jden = _jax_out(name, "float32")
    tout, tden = _twin(name, "float32")
    np.testing.assert_array_equal(tden.numpy(), jden)
    np.testing.assert_allclose(tout.numpy(), jout, **F32_TOL)
    assert np.abs(jout).max() > 0.1


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_k2_list_bf16_twin_matches_jax(name):
    jout, jden = _jax_out(name, "bfloat16")
    tout, tden = _twin(name, "bfloat16")
    f32 = _twin(name, "float32")[0].numpy()
    np.testing.assert_array_equal(tden.numpy(), jden)
    assert rel_l2(tout, jout) < BOUND, rel_l2(tout, jout)
    assert rel_l2(tout, jout) < 0.1 * rel_l2(f32, jout), (rel_l2(tout, jout), rel_l2(f32, jout))


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_k4_list_twin_matches_jax_vjp(name):
    jdx, jdw = _jax_grads(name, "float32")
    tdx, tdw = _twin_grads(name, "float32")
    np.testing.assert_allclose(tdx, jdx, **GRAD_TOL)
    np.testing.assert_allclose(tdw, jdw, **GRAD_TOL)
    assert np.abs(jdx).max() > 1e-2 and np.abs(jdw).max() > 1e-2


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_k4_list_bf16_twin_matches_jax_vjp(name):
    jdx, jdw = _jax_grads(name, "bfloat16")
    tdx, tdw = _twin_grads(name, "bfloat16")
    fdx, fdw = _twin_grads(name, "float32")
    for got, want, f32 in ((tdx, jdx, fdx), (tdw, jdw, fdw)):
        assert rel_l2(got, want) < BOUND, rel_l2(got, want)
        assert rel_l2(got, want) < 0.1 * rel_l2(f32, want), (rel_l2(got, want),
                                                             rel_l2(f32, want))


# --- (d) the kernels' route from the lists ---


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_k2_k4_list_route_from_lists_matches_twins(name):
    _, port, x, w, kp, cot, _ = _case(name)
    lists = _given_lists(name)
    ns = port["s_rows"].shape[0]
    xs, wt, kpt = _pad(torch.from_numpy(x), ns), torch.from_numpy(w), torch.from_numpy(kp)
    route = (lists, port["q_rows"], port["s_rows"])
    out, den, _ = band_conv_from_lists(*route, xs, wt, kpt, port["extent"])
    tout, tden = _twin(name, "float32")
    assert torch.equal(den, tden)
    np.testing.assert_allclose(out.numpy(), tout.numpy(), **F32_TOL)
    g = torch.zeros((port["q_rows"].shape[0], w.shape[2]))
    g[: cot.shape[0]] = torch.from_numpy(cot)
    dx, dw = band_conv_bwd_from_lists(*route, xs, wt, kpt, g / den[:, None], port["extent"])
    tdx, tdw = _twin_grads(name, "float32")
    np.testing.assert_allclose(dx[: x.shape[0]].numpy(), tdx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), tdw, **GRAD_TOL)

    bf = dict(chunk=port["chunk"], starts=port["starts"], tile=port["query_tile"])
    bout, bden, _ = band_conv_from_lists(*route, xs, wt, kpt, port["extent"], **bf)
    tbout, tbden = _twin(name, "bfloat16")
    assert torch.equal(bden, tbden)
    assert rel_l2(bout, tbout) < TWIN_BOUND, rel_l2(bout, tbout)
    bdx, bdw = band_conv_bwd_from_lists(*route, xs, wt, kpt, g / bden[:, None],
                                        port["extent"], **bf)
    tbdx, tbdw = _twin_grads(name, "bfloat16")
    assert rel_l2(bdx[: x.shape[0]], tbdx) < TWIN_BOUND, rel_l2(bdx[: x.shape[0]], tbdx)
    assert rel_l2(bdw, tbdw) < TWIN_BOUND, rel_l2(bdw, tbdw)


def test_kernels_refuse_lists_of_the_other_mode():
    from d3feat_tpu_torch.ops.band_conv import _list_args
    from d3feat_tpu_torch.ops.band_lists import BandLists

    q_rows = _case("standalone")[1]["q_rows"]
    given = _given_lists("standalone")
    with pytest.raises(ValueError, match="list-mode lists for a threshold-mode call"):
        _list_args(given, q_rows, torch.zeros(q_rows.shape[0]))
    thr_lists = BandLists(given.lpos, torch.zeros(given.lpos.shape), given.lcnt)
    with pytest.raises(ValueError, match="threshold-mode lists for a list-mode call"):
        _list_args(thr_lists, q_rows, None)
    with pytest.raises(ValueError, match="BandLists"):
        BandLists(given.lpos, None, given.lcnt)


# --- (e), (f): the model ---


def _no_thr(pyr_np, features):
    return dict(torch_batch_from_jax(pyr_np, features), sel_thr={})


def test_forward_without_thresholds_matches_jax():
    from d3feat_tpu.models.kpfcnn import apply_kpfcnn as j_apply, init_kpfcnn as j_init
    from d3feat_tpu_torch.compat.weights import params_from_numpy
    from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn

    _, (_, feats, _), pyr = jax_pyramid(3, LAYERS)
    jcfg = jax_config(LAYERS, eval_gate_topm=0)
    params, state, specs = j_init(jax.random.key(2), jcfg)
    feats_sorted = feats[pyr["band"][0]["order"]]
    jbatch = jax.tree.map(jnp.asarray, dict(pyr, features=feats_sorted, sel_thr={}))
    jout, _, _ = j_apply(params, state, jbatch, jcfg, specs, train=False, per_cloud_norm=True)
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    batch = _no_thr(pyr, feats_sorted)
    tout = apply_kpfcnn(model, batch, per_cloud_norm=True)
    assert sorted(batch["band_args"]) == sorted({
        f"{'pool' if s.strided else 'conv'}{s.layer}:list" for s in model.specs.encoder
        if s.kind in ("simple", "resnetb")})
    np.testing.assert_allclose(tout.features.numpy(), np.asarray(jout.features), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tout.scores.numpy(), np.asarray(jout.scores), rtol=0, atol=1e-5)
    assert (np.asarray(jout.scores) > 0).sum() > 50


@pytest.fixture(scope="module")
def jax_list_step():
    """JAX's train step jitted on a pyramid without thresholds: the test
    side drops ``sel_thr`` from what ``build_pyramid`` returns."""
    import d3feat_tpu.train.step as j_step_mod
    from d3feat_tpu.train import init_train_state, make_train_step as j_make_train

    jcfg = jax_config(LAYERS)
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    build = j_step_mod.build_pyramid
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_step_mod, "build_pyramid",
                   lambda *a, **kw: dict(build(*a, **kw), sel_thr={}))
        step = jax.jit(j_make_train(jcfg, specs, pyramid_spec=jax_band_spec(jcfg)))
        b = pair_batch(3)
        ts2, jm = step(ts, {k: jnp.asarray(v) for k, v in b.items()}, jnp.int32(0))
    return jcfg, ts, ts2, jm, b


def test_train_step_without_thresholds_matches_jax(jax_list_step):
    from d3feat_tpu_torch.compat.weights import params_from_numpy
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
    from d3feat_tpu_torch.train.step import TrainState, make_train_step

    jcfg, ts, ts2, jm, b = jax_list_step
    np_ = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree))  # noqa: E731
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(np_(ts.params))
    state = TrainState(model, make_optimizer(tcfg, model))
    _, _, pyr = jax_pyramid(3, LAYERS)
    tb = {k: _t(v) for k, v in b.items()}
    state, tm = make_train_step(tcfg)(state, tb, 0, pyramid=_no_thr(pyr, np.zeros((512, 1))))
    for f in ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "skipped",
              "overflow"):
        np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5, err_msg=f)
    trace, params = np_(ts2.opt_state[-1].trace), np_(ts.params)
    jgrads = {k: trace[k] - jcfg.weight_decay * params[k] for k in trace}
    for name, t in train_tensors(state.model):
        np.testing.assert_allclose(t.grad.numpy(), jgrads[name].numpy(), **GRAD_TOL,
                                   err_msg=name)
    assert max(float(g.abs().max()) for g in jgrads.values()) > 1e-2


@pytest.mark.parametrize("seed", [3, 5])
def test_bandhead_train_false_takes_the_gather_head(seed, monkeypatch):
    from d3feat_tpu.models.kpfcnn import detection_scores as j_detection_scores
    from d3feat_tpu_torch.models.kpfcnn import detection_scores
    from d3feat_tpu_torch.ops import head as head_ops

    jcfg, _, pyr = jax_pyramid(seed)
    jcfg = jax_config(bandhead_train=False)
    c0 = pyr["points"][0].shape[0]
    rng = np.random.default_rng(seed + 13)
    f = (rng.uniform(0.0, 1.0, size=(c0, 32)) * pyr["masks"][0][:, None]).astype(np.float32)
    w = rng.normal(size=(c0, 1)).astype(np.float32)
    jpyr = jax.tree.map(jnp.asarray, pyr)
    jv, jg = jax.value_and_grad(lambda ff: jnp.sum(w * j_detection_scores(
        jpyr, ff, train=True, config=jcfg)))(jnp.asarray(f))

    def refuse(*a, **kw):
        raise AssertionError("the band head ran with bandhead_train=False")

    monkeypatch.setattr(head_ops.BandHeadFn, "apply", refuse)
    batch = torch_batch_from_jax(pyr, np.zeros((c0, 1)))
    ft = torch.tensor(f, requires_grad=True)
    tv = (torch.from_numpy(w) * detection_scores(batch, ft, config=torch_config(jcfg),
                                                 train=True)).sum()
    (tg,) = torch.autograd.grad(tv, (ft,))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-5)
    assert "band_args" not in batch  # neither mode's arguments were built for the head


def test_memo_keeps_both_modes_apart():
    jcfg, _, pyr = jax_pyramid(3)
    cfg = torch_config(jcfg)
    r0 = jcfg.first_subsampling_dl * jcfg.conv_radius
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    thr_args = search_inputs(batch, cfg, 0, False, r0, impl="plain")
    list_args = search_inputs(dict(batch, sel_thr={}), cfg, 0, False, r0, impl="plain")
    assert sorted(batch["band_args"]) == ["conv0", "conv0:list"]
    assert thr_args["thr"] is not None and "neighb" not in thr_args
    assert list_args["thr"] is None and list_args["neighb"].shape == (
        pyr["neighbors"][0].shape[1], thr_args["q_rows"].shape[0])
    # the padded queries list the shadow
    n0 = pyr["points"][0].shape[0]
    assert (list_args["neighb"][:, n0:] == n0).all()
