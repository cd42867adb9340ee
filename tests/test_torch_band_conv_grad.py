"""K4: the port's band-KPConv backward twin, through ``BandConvFn`` with
``impl="plain"``, vs the VJP of JAX ``band_conv_ad`` in threshold mode
(Pallas in interpret mode): dx and dW at atol 5e-4 / rtol 1e-3
(``tests/test_band_conv_grad.py``). Two inputs: the standalone level of
that test (250 + 200 points, capacity 512, Cin 8, Cout 16, 15 kernel
points, 64-query tiles) and the strided pool0 conv of the shared JAX
pyramid. The twin's explicit products are also held against PyTorch
autograd through the forward twin ``band_conv_plain`` at 1e-5, and the CUDA
kernels' decomposition over the list stage's lists, emulated in plain
PyTorch, against the same JAX VJP."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.kernel_points import load_kernels as j_load_kernels
from d3feat_tpu.ops.neighbors import SortedLevel, make_level_frame, radius_neighbors_sorted
from d3feat_tpu.ops.pallas.band_conv import band_conv_ad
from d3feat_tpu_torch.models.blocks import band_query_tiles
from d3feat_tpu_torch.ops.band_conv import BandConvFn, band_conv_plain
from d3feat_tpu_torch.ops.band_lists import band_lists
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import band_conv_bwd_from_lists, band_conv_from_lists, jax_pyramid
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX inputs, port inputs, x_sorted [n, Cin], W, cotangent [n_q, Cout])."""
    if name == "standalone":
        rng = np.random.default_rng(0)
        n0, n1, cap = 250, 200, 512
        pts = np.concatenate([
            rng.uniform(0, 1, size=(n0, 3)) * np.array([3.0, 1.0, 0.5]),
            rng.uniform(0, 1, size=(n1, 3)) * np.array([0.7, 2.4, 0.8])]).astype(np.float32)
        padded = np.full((cap, 3), 1.0e6, np.float32)
        padded[: len(pts)] = pts
        lens = jnp.asarray(np.array([n0, n1], np.int32))
        r, k, cin, cout, tile, band = 0.4, 12, 8, 16, 64, 512
        axis, origin = make_level_frame(jnp.asarray(padded), lens, 2)
        lvl = SortedLevel(jnp.asarray(padded), lens, 2, axis, origin, band_pad=512)
        _, ov, thr, ptie = radius_neighbors_sorted(
            lvl, lvl, r, max_k=k, query_tile=tile, band_cap=band, interpret=True,
            raw_positions=True, with_threshold=True)
        assert not bool(ov)
        q_packed, s_packed = np.asarray(lvl.q_packed), np.asarray(lvl.s_packed)
        qkey = skey = np.asarray(lvl.key_sorted)
        n_s, n_q, n_valid = cap, cap, len(pts)
        x = rng.normal(size=(cap, cin)).astype(np.float32)
        x[n_valid:] = 0.0
        x_sorted = x[np.asarray(lvl.order)]
    else:  # strided pool0 conv of the shared pyramid
        jcfg, _, pyr = jax_pyramid(3)
        rng = np.random.default_rng(11)
        r = jcfg.first_subsampling_dl * jcfg.conv_radius
        cin, cout, tile = 8, 8, 128
        q_packed, s_packed = pyr["band"][1]["q_packed"], pyr["band"][0]["s_packed"]
        qkey, skey = pyr["band"][1]["key_sorted"], pyr["band"][0]["key_sorted"]
        thr, ptie = pyr["sel_thr"]["pool0"]
        n_s, n_q = pyr["points"][0].shape[0], pyr["points"][1].shape[0]
        band = level_band_cap(n_s, 2, 0.1, tile=tile, ratio=-(-n_s // n_q))
        n_valid = int(pyr["lengths"][0].sum())
        x_sorted = np.zeros((n_s, cin), np.float32)
        x_sorted[:n_valid] = rng.normal(size=(n_valid, cin))
    w = (rng.normal(size=(15, cin, cout)) * 0.3).astype(np.float32)
    kp = j_load_kernels(r, 15, deterministic=True).astype(np.float32)
    cot = rng.normal(size=(n_q, cout)).astype(np.float32)
    extent = r * 2.0 / 2.5

    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    qb = {"q_rows": t(q_packed[:4].T), "key_sorted": t(qkey)}
    sb = {"key_sorted": t(skey)}
    q_rows, starts, ends, thr_p, ptie_p = band_query_tiles(
        qb, sb, 2, r, tile, n_s, t(thr), t(ptie))
    ws, we = band_windows(starts, ends, band)
    port = dict(q_rows=q_rows.contiguous(), thr=thr_p, ptie=ptie_p,
                s_rows=t(s_packed[:, :4]), starts=ws, wends=we, query_tile=tile,
                extent=extent)
    qp = np.zeros((8, q_rows.shape[0]), np.float32)
    qp[:4] = q_rows.numpy().T
    jx = dict(q_packed=jnp.asarray(qp), s_packed=jnp.asarray(s_packed),
              starts=jnp.asarray(starts.numpy().astype(np.int32)),
              ends=jnp.asarray(ends.numpy().astype(np.int32)),
              thr=jnp.asarray(thr_p.numpy()), ptie=jnp.asarray(ptie_p.numpy()),
              band=band, tile=tile, extent=extent)
    return jx, port, x_sorted, w, kp, cot


def _pad(x, n_rows):
    return torch.cat([x, x.new_zeros((n_rows - x.shape[0], x.shape[1]))])


def _port_grads(port, x_sorted, w, kp, cot, impl="plain"):
    x = torch.tensor(x_sorted, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = BandConvFn.apply(_pad(x, port["s_rows"].shape[0]), wt, torch.from_numpy(kp),
                           port, impl)
    loss = (out[: cot.shape[0]] * torch.from_numpy(cot)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (x, wt))]


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """(dx, dW) of the JAX ``band_conv_ad`` VJP for the case's cotangent."""
    jx, port, x_sorted, w, kp, cot = _case(name)
    n_rows = jx["s_packed"].shape[0]

    def loss(x_in, w_in):
        x_pad = jnp.concatenate([x_in, jnp.zeros((n_rows - x_in.shape[0], x_in.shape[1]))])
        out = band_conv_ad(jx["band"], jx["tile"], True, "float32", jx["q_packed"],
                           jnp.zeros((1, jx["q_packed"].shape[1]), jnp.int32), jx["s_packed"],
                           x_pad, w_in, jnp.asarray(kp), jx["starts"],
                           jnp.float32(jx["extent"]), jx["ends"], jx["thr"], jx["ptie"])
        return jnp.sum(out[: cot.shape[0]] * cot)

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x_sorted), jnp.asarray(w))
    return np.asarray(jdx), np.asarray(jdw)


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_band_conv_bwd_twin_matches_pallas_vjp(name):
    jx, port, x_sorted, w, kp, cot = _case(name)
    jdx, jdw = _jax_grads(name)
    tdx, tdw = _port_grads(port, x_sorted, w, kp, cot)
    np.testing.assert_allclose(tdx, np.asarray(jdx), **GRAD_TOL)
    np.testing.assert_allclose(tdw, np.asarray(jdw), **GRAD_TOL)
    assert np.abs(tdx).max() > 1e-2 and np.abs(tdw).max() > 1e-2  # not vacuous


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_band_conv_bwd_from_lists_matches_pallas_vjp(name):
    """The kernels' backward decomposition (dW = weighted^T gs; G = sum of
    w gs gathered over the transposed lists, dx = G W^T), emulated in plain
    PyTorch from the list stage's lists and the forward's density, against
    the JAX VJP."""
    _, port, x_sorted, w, kp, cot = _case(name)
    jdx, jdw = _jax_grads(name)
    ns = port["s_rows"].shape[0]
    x = _pad(torch.from_numpy(x_sorted), ns)
    lists = band_lists(**{k: v for k, v in port.items() if k != "extent"})
    _, den, _ = band_conv_from_lists(lists, port["q_rows"], port["s_rows"], x,
                                     torch.from_numpy(w), torch.from_numpy(kp), port["extent"])
    g = torch.zeros((port["q_rows"].shape[0], w.shape[2]))
    g[: cot.shape[0]] = torch.from_numpy(cot)
    dx, dw = band_conv_bwd_from_lists(lists, port["q_rows"], port["s_rows"], x,
                                      torch.from_numpy(w), torch.from_numpy(kp),
                                      g / den[:, None], port["extent"])
    np.testing.assert_allclose(dx[: x_sorted.shape[0]].numpy(), jdx, **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **GRAD_TOL)
    assert np.abs(jdx).max() > 1e-2 and np.abs(jdw).max() > 1e-2  # not vacuous


@pytest.mark.parametrize("name", ["standalone", "pool0"])
def test_band_conv_bwd_twin_matches_autograd(name):
    _, port, x_sorted, w, kp, cot = _case(name)
    x = torch.tensor(x_sorted, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out, _ = band_conv_plain(x=_pad(x, port["s_rows"].shape[0]), weights=wt,
                             kernel_points=torch.from_numpy(kp), **port)
    loss = (out[: cot.shape[0]] * torch.from_numpy(cot)).sum()
    adx, adw = torch.autograd.grad(loss, (x, wt))
    tdx, tdw = _port_grads(port, x_sorted, w, kp, cot)
    np.testing.assert_allclose(tdx, adx.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tdw, adw.numpy(), atol=1e-5, rtol=1e-5)


def test_band_conv_fn_skips_dx_without_input_grad():
    _, port, x_sorted, w, kp, cot = _case("standalone")
    wt = torch.tensor(w, requires_grad=True)
    x = _pad(torch.from_numpy(x_sorted), port["s_rows"].shape[0])
    out = BandConvFn.apply(x, wt, torch.from_numpy(kp), port, "plain")
    (dw,) = torch.autograd.grad((out[: cot.shape[0]] * torch.from_numpy(cot)).sum(), (wt,))
    np.testing.assert_array_equal(dw.numpy(), _port_grads(port, x_sorted, w, kp, cot)[1])
