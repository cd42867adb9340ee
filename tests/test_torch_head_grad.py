"""K5: the port's band-head backward twin, through ``BandHeadFn`` with
``impl="plain"``, vs the VJP of JAX ``band_head_ad`` (Pallas in interpret
mode) on the shared pyramid's level-0 band, and the training detector head
as a whole (``detection_scores(train=True)``, which reaches K3 and K5) vs
JAX's, values and gradients at atol 1e-5 / rtol 1e-5
(``tests/test_band_head.py``). Also the per-row tile ranges that the K4
and K5 kernels walk (``covering_tiles``) against a brute-force search."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.kpfcnn import detection_scores as j_detection_scores
from d3feat_tpu.ops.pallas.head import band_head_ad
from d3feat_tpu_torch.models.blocks import band_query_tiles
from d3feat_tpu_torch.models.kpfcnn import band_head_inputs, detection_scores
from d3feat_tpu_torch.ops.head import BandHeadFn, band_head_bwd
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from d3feat_tpu_torch.ops.select import covering_tiles
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax, torch_config

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 8)])
def test_band_head_bwd_twin_matches_pallas_vjp(seed, c):
    jcfg, _, pyr = jax_pyramid(seed)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    args = band_head_inputs(batch, torch_config(jcfg))
    ns = args["s_rows"].shape[0]
    n = int(pyr["lengths"][0].sum())
    rng = np.random.default_rng(seed + 21)
    x = np.zeros((ns, c), np.float32)
    x[:n] = rng.uniform(0.0, 1.0, size=(n, c))
    g = rng.normal(size=(args["q_rows"].shape[0], c)).astype(np.float32)

    # the JAX band of the same tiles: raw window ends, which band_head_ad rounds itself
    b0 = batch["band"][0]
    thr, ptie = batch["sel_thr"]["conv0"]
    r0 = jcfg.first_subsampling_dl * jcfg.conv_radius
    s_rows = batch["points"][0].shape[0]
    q_rows, starts, ends, thr_p, ptie_p = band_query_tiles(b0, b0, 2, r0, 256, s_rows, thr, ptie)
    band_cap = level_band_cap(s_rows, 2, 0.1, tile=256, ratio=1)
    assert torch.equal(band_windows(starts, ends, band_cap)[1], args["wends"])
    q_packed = np.zeros((8, q_rows.shape[0]), np.float32)
    q_packed[:4] = q_rows.numpy().T
    q_packed[4], q_packed[5] = thr_p.numpy(), ptie_p.numpy()
    jdx = jax.grad(lambda xx: jnp.sum(band_head_ad(
        band_cap, 256, True, jnp.asarray(q_packed), jnp.asarray(pyr["band"][0]["s_packed"]), xx,
        jnp.asarray(starts.numpy().astype(np.int32)),
        jnp.asarray(ends.numpy().astype(np.int32)))[0][:, :c] * g))(jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    fsum, cnt = BandHeadFn.apply(xt, args, "plain")
    (tdx,) = torch.autograd.grad((fsum * torch.from_numpy(g)).sum(), (xt,))
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    assert np.abs(tdx.numpy()).max() > 1.0
    direct = band_head_bwd(g=torch.from_numpy(g), impl="plain", **args)
    np.testing.assert_array_equal(direct.numpy(), tdx.numpy())


@pytest.mark.parametrize("seed", [3, 5])
def test_train_detection_scores_match_jax(seed):
    jcfg, _, pyr = jax_pyramid(seed)
    c0 = pyr["points"][0].shape[0]
    rng = np.random.default_rng(seed + 13)
    f = (rng.uniform(0.0, 1.0, size=(c0, 32)) * pyr["masks"][0][:, None]).astype(np.float32)
    w = rng.normal(size=(c0, 1)).astype(np.float32)
    jpyr = jax.tree.map(jnp.asarray, pyr)
    jv, jg = jax.value_and_grad(lambda ff: jnp.sum(w * j_detection_scores(
        jpyr, ff, train=True, config=jcfg)))(jnp.asarray(f))

    batch = torch_batch_from_jax(pyr, np.zeros((c0, 1)))
    ft = torch.tensor(f, requires_grad=True)
    tv = (torch.from_numpy(w) * detection_scores(batch, ft, config=torch_config(jcfg),
                                                 train=True)).sum()
    (tg,) = torch.autograd.grad(tv, (ft,))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covering_tiles_hold_every_window(seed):
    """Every tile whose window holds a row lies in the row's range, also
    for windows whose ends are not monotone and for empty windows."""
    rng = np.random.default_rng(seed)
    n_tiles, n_rows = 12, 300
    starts = np.sort(rng.integers(0, 250, n_tiles))
    wends = np.minimum(starts + rng.integers(0, 120, n_tiles), n_rows)
    wends[3] = starts[3]  # an empty window
    first, end = covering_tiles(torch.from_numpy(starts).int(), torch.from_numpy(wends).int(),
                                n_rows)
    for r in range(n_rows):
        covering = [t for t in range(n_tiles) if starts[t] <= r < wends[t]]
        assert all(first[r] <= t < end[r] for t in covering), r
    assert (end - first).max() < n_tiles  # the ranges do narrow the search
