"""K5: the port's band-head backward twin, through ``BandHeadFn`` with
``impl="plain"``, vs the VJP of JAX ``band_head_ad`` (Pallas in interpret
mode) on the shared pyramid's level-0 band, and the training detector head
as a whole (``detection_scores(train=True)``, which reaches K3 and K5) vs
JAX's, values and gradients at atol 1e-5 / rtol 1e-5
(``tests/test_band_head.py``).

The CUDA kernel (``ops/cuda/head_bwd.cu``) reads the transpose of conv0's
lists where the twin and the TPU kernel select from the windows; its
route is emulated on the CPU from the lists' twins (``head_bwd_from_lists``:
each support row's listed queries in ascending order, a float32 partial
per tile added into the row's total where the tile changes) and held bit
for bit against the twin and at the JAX tolerance against the JAX VJP."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.kpfcnn import detection_scores as j_detection_scores
from d3feat_tpu.ops.pallas.head import band_head_ad
from d3feat_tpu_torch.models.blocks import band_conv_inputs, band_query_tiles
from d3feat_tpu_torch.models.kpfcnn import band_head_inputs, detection_scores, make_kpfcnn_specs
from d3feat_tpu_torch.ops import head as head_ops
from d3feat_tpu_torch.ops.band_lists import LCAP, band_lists_plain
from d3feat_tpu_torch.ops.head import BandHeadFn, band_head_bwd, band_head_bwd_plain
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)


def head_bwd_from_lists(lists, g, query_tile, n_rows):
    """The K5 kernel's route on the CPU: dx [n_rows, C] from the transpose
    of the search's lists, in float32 as the kernel rounds. Each support
    row walks its entries (ascending query order) and keeps a running
    partial of its current tile, added into the row's total where the tile
    changes; the last partial is added at the end."""
    row_ptr, pairs = lists.transpose(n_rows)
    start, cnt = row_ptr[:-1].long(), (row_ptr[1:] - row_ptr[:-1]).long()
    acc = g.new_zeros((n_rows, g.shape[1]))
    part = torch.zeros_like(acc)
    cur = torch.full((n_rows,), -1, dtype=torch.long)
    for j in range(int(cnt.max())):
        live = j < cnt
        q = pairs[(start + j).clamp(max=pairs.shape[0] - 1)].long() // LCAP
        t = q // query_tile
        new = live & (t != cur)
        acc = torch.where(new[:, None], acc + part, acc)
        part = torch.where(new[:, None], 0.0, part)
        cur = torch.where(new, t, cur)
        part = torch.where(live[:, None], part + g[q], part)
    return acc + part


@functools.lru_cache(maxsize=None)
def _case(seed, c):
    """(band_head arguments of the level-0 band, x, g, the JAX VJP dx)."""
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
    return args, x, g, np.asarray(jdx)


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 8)])
def test_band_head_bwd_twin_matches_pallas_vjp(seed, c):
    args, x, g, jdx = _case(seed, c)
    xt = torch.tensor(x, requires_grad=True)
    fsum, cnt = BandHeadFn.apply(xt, args, "plain")
    (tdx,) = torch.autograd.grad((fsum * torch.from_numpy(g)).sum(), (xt,))
    np.testing.assert_allclose(tdx.numpy(), jdx, **TOL)
    assert np.abs(tdx.numpy()).max() > 1.0
    direct = band_head_bwd(g=torch.from_numpy(g), impl="plain", **args)
    np.testing.assert_array_equal(direct.numpy(), tdx.numpy())


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 8), (3, 40)])
def test_band_head_bwd_list_route_matches_twin_and_pallas(seed, c):
    args, _, g, jdx = _case(seed, c)
    qt = args["query_tile"]
    lists = band_lists_plain(**{k: args[k] for k in ("q_rows", "thr", "ptie", "s_rows",
                                                     "starts", "wends", "query_tile")})
    gt = torch.from_numpy(g)
    ldx = head_bwd_from_lists(lists, gt, qt, args["s_rows"].shape[0])
    pdx = band_head_bwd_plain(g=gt, **{k: v for k, v in args.items() if k != "lists"})
    assert torch.equal(ldx, pdx)
    np.testing.assert_allclose(ldx.numpy(), jdx, **TOL)
    # not vacuous: some support row is listed by queries of two tiles, so
    # the adds at tile boundaries are exercised
    row_ptr, pairs = lists.transpose(args["s_rows"].shape[0])
    tiles = (pairs[:int(row_ptr[-1])].long() // LCAP) // qt
    rows = torch.repeat_interleave(torch.arange(row_ptr.shape[0] - 1),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    first = torch.full((row_ptr.shape[0] - 1,), 1 << 30).scatter_reduce(0, rows, tiles, "amin")
    assert bool((tiles > first[rows]).any())
    assert float(ldx.abs().max()) > 1.0


def test_bwd_kernel_route_needs_lists_and_cuda():
    args, _, g, _ = _case(3, 32)
    gt = torch.from_numpy(g)
    plain_args = {k: v for k, v in args.items() if k != "lists"}
    with pytest.raises(ValueError, match="no lists"):
        band_head_bwd(g=gt, impl="kernel", **plain_args)
    lists = band_lists_plain(**{k: args[k] for k in ("q_rows", "thr", "ptie", "s_rows",
                                                     "starts", "wends", "query_tile")})
    with pytest.raises(ValueError, match="CUDA"):
        band_head_bwd(g=gt, impl="kernel", lists=lists, **plain_args)


def test_head_backward_shares_conv0_lists(monkeypatch):
    """``BandHeadFn.backward`` hands K5 the ``BandLists`` of conv0 that the
    level-0 convs use, with conv0's support rows, so one memoised
    transpose serves K5 and K4's conv0 backward."""
    jcfg, _, pyr = jax_pyramid(3)
    cfg = torch_config(jcfg)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    conv0 = make_kpfcnn_specs(cfg).encoder[0]
    conv_args = band_conv_inputs(conv0, batch, cfg)
    # the lists the kernel path keeps with conv0's search arguments
    batch["band_args"]["conv0"]["lists"] = band_lists_plain(
        **{k: conv_args[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts", "wends",
                                     "query_tile")})
    seen = []

    def spy(*a, lists=None, **kw):
        seen.append((lists, a[3]))
        return band_head_bwd_plain(*a, query_tile=kw["query_tile"])

    monkeypatch.setattr(head_ops, "band_head_bwd", spy)
    c0 = pyr["points"][0].shape[0]
    f = torch.rand((c0, 32), generator=torch.Generator().manual_seed(0), requires_grad=True)
    detection_scores(batch, f, config=cfg, train=True, impl="plain").sum().backward()
    assert len(seen) == 1 and f.grad is not None
    conv_args = band_conv_inputs(conv0, batch, cfg)
    assert seen[0][0] is conv_args["lists"]
    assert seen[0][1] is conv_args["s_rows"]


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
