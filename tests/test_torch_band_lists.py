"""The list stage of K2/K4 (``ops/band_lists.py``) and the arithmetic the
redesigned kernels rest on, on the CPU.

- The lists' twin against ``threshold_select`` (each query's selected
  window rows, in position order, with their d2) and against the JAX
  package: its pyramid's K1 lists as sets, and the squared distances of
  its K1 kernel (Pallas in interpret mode) over the same windows, bit for
  bit.
- The transpose that K4's dx pass walks: each support row's listed
  entries, ascending query order.
- The 3xTF32 product of the kernels (each f32 operand split into two TF32
  words, rounded to nearest; three TF32 products), emulated by masking the
  f32 words, at K2's level-4 shape: within K2's tolerance of the float64
  product, where plain TF32 is not. With the tensor cores' additions
  emulated as truncating (each 8-deep MMA step rounded toward zero), the
  kernels' 32-deep stage accumulators added in f32 round-to-nearest keep
  K2's level-4 product and K4's dW (32768 queries deep) within tolerance,
  where one accumulator over the whole reduction does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.select import band_select as j_band_select
from d3feat_tpu_torch.models.blocks import band_query_tiles
from d3feat_tpu_torch.ops.band_conv import threshold_select
from d3feat_tpu_torch.ops.band_lists import LCAP, BandLists, band_lists, band_lists_plain
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from d3feat_tpu_torch.ops.select import tile_windows
from tests.torch_port_helpers import NEIGHBORS, jax_pyramid, torch_batch_from_jax
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

# (search, support level, strided): the searches of K2's level-0, pool and deep convs
SEARCHES = [("conv0", 0, False), ("pool0", 0, True), ("conv1", 1, False), ("conv2", 2, False)]


def _search(name, l, strided):
    """(JAX pyramid, band args of the search as ``band_conv_inputs`` makes
    them, number of live queries, band cap, radius)."""
    jcfg, _, pyr = jax_pyramid(3)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    q_level = l + 1 if strided else l
    qb, sb = batch["band"][q_level], batch["band"][l]
    r = jcfg.first_subsampling_dl * jcfg.conv_radius * 2.0**l
    tile = 128 if strided else 256
    s_rows = batch["points"][l].shape[0]
    n_q = batch["points"][q_level].shape[0]
    thr, ptie = batch["sel_thr"][name]
    q_rows, starts, ends, thr_p, ptie_p = band_query_tiles(qb, sb, 2, r, tile, s_rows, thr, ptie)
    band_cap = level_band_cap(s_rows, 2, 0.1, tile=tile, ratio=-(-s_rows // n_q))
    ws, we = band_windows(starts, ends, band_cap)
    args = dict(q_rows=q_rows.contiguous(), thr=thr_p, ptie=ptie_p, s_rows=sb["s_rows"],
                starts=ws, wends=we, query_tile=tile)
    return pyr, args, n_q, band_cap, r


@pytest.mark.parametrize("name,l,strided", SEARCHES)
def test_lists_twin_follows_threshold_select(name, l, strided):
    _, args, n_q, _, _ = _search(name, l, strided)
    lists = band_lists(**args)  # CPU tensors: the twin
    assert isinstance(lists, BandLists) and lists.lpos.shape == (args["q_rows"].shape[0], LCAP)
    tile = args["query_tile"]
    rows, pos, inside = tile_windows(args["s_rows"], args["starts"], args["wends"])
    sel, d2 = threshold_select(rows, pos, inside, args["q_rows"], args["thr"], args["ptie"], tile)
    sel, d2 = sel.reshape(-1, sel.shape[-1]).numpy(), d2.reshape(-1, d2.shape[-1]).numpy()
    pos = pos.numpy()
    lpos, ld2, lcnt = lists.lpos.numpy(), lists.ld2.numpy(), lists.lcnt.numpy()
    for q in range(lpos.shape[0]):
        idx = np.nonzero(sel[q])[0]
        n = len(idx)
        assert lcnt[q] == n <= LCAP
        assert np.array_equal(lpos[q, :n], pos[q // tile, idx])
        assert np.all(np.diff(lpos[q, :n]) > 0)  # ascending position
        assert np.array_equal(ld2[q, :n].view(np.int32), d2[q, idx].view(np.int32))
        assert np.all(lpos[q, n:] == -1) and np.all(ld2[q, n:] == 0.0)
    assert int(lcnt[n_q:].sum()) == 0  # padding queries list nothing
    assert int(lcnt.sum()) > 5 * n_q   # the comparison is not vacuous


@pytest.mark.parametrize("name,l,strided", SEARCHES)
def test_lists_reproduce_jax_k1_lists(name, l, strided):
    """The rows selected from K1's thresholds are K1's list (as a set), and
    their d2 are the JAX K1 kernel's over the same windows, bit for bit."""
    pyr, args, n_q, band_cap, r = _search(name, l, strided)
    lists = band_lists_plain(**args)
    ref = pyr["pools" if strided else "neighbors"][l]
    n_s = pyr["points"][l].shape[0]
    tile = args["query_tile"]
    q_packed = np.zeros((8, args["q_rows"].shape[0]), np.float32)
    q_packed[:4] = args["q_rows"].numpy().T
    r2 = np.float32(r) * np.float32(r)
    jpos, jd2 = j_band_select(
        jnp.asarray(q_packed), jnp.asarray(pyr["band"][l]["s_packed"]),
        jnp.asarray(args["starts"].numpy()), r2, jnp.asarray(args["wends"].numpy()),
        max_k=NEIGHBORS, band_cap=band_cap, query_tile=tile, interpret=True, with_dists=True)
    jpos, jd2 = np.asarray(jpos), np.asarray(jd2)
    lpos, ld2, lcnt = lists.lpos.numpy(), lists.ld2.numpy(), lists.lcnt.numpy()
    for q in range(n_q):
        got = lpos[q, :lcnt[q]]
        assert set(got.tolist()) == set(ref[q][ref[q] < n_s].tolist()), q
        k1 = {int(p): d for p, d in zip(jpos[q], jd2[q]) if d < 3.0e38}
        assert set(k1) == set(got.tolist()), q
        assert all(np.float32(k1[int(p)]).view(np.int32) == np.float32(d).view(np.int32)
                   for p, d in zip(got, ld2[q, :lcnt[q]])), q


def test_transpose_lists_each_row_in_query_order():
    _, args, _, _, _ = _search("pool0", 0, True)
    lists = band_lists_plain(**args)
    ns = args["s_rows"].shape[0]
    row_ptr, pairs = (t.numpy() for t in lists.transpose(ns))
    lpos, lcnt = lists.lpos.numpy(), lists.lcnt.numpy()
    want = {}
    for q in range(lpos.shape[0]):
        for j in range(lcnt[q]):
            want.setdefault(int(lpos[q, j]), []).append(q * LCAP + j)
    assert row_ptr[0] == 0 and row_ptr[-1] == int(lcnt.sum())
    for r in range(ns):
        assert pairs[row_ptr[r]:row_ptr[r + 1]].tolist() == want.get(r, []), r
    assert lists.transpose(ns) is lists.transpose(ns)  # built once, then kept


def test_transpose_kept_per_row_count_and_route():
    _, args, _, _, _ = _search("conv1", 1, False)
    lists = band_lists_plain(**args)
    ns = args["s_rows"].shape[0]
    t = lists.transpose(ns)
    assert lists.transpose(ns, impl="plain") is t  # CPU lists: "auto" takes the twin too
    row_ptr, pairs = lists.transpose(ns + 8)
    assert row_ptr.shape == (ns + 9,) and torch.equal(row_ptr[:ns + 1], t[0])
    assert torch.equal(pairs, t[1]) and lists.transpose(ns) is t


def _tf32(a):
    """float32 -> TF32 (10 mantissa bits), rounded to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), by masking the f32 words."""
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32((a - hi).astype(np.float32))


def _level4_product():
    """K2's second product at level 4 (512 queries x 15 * 512 -> 512): weighted
    rows of O(1) like the forward's, weights at the r5 level-4 scale
    (standard deviation 0.003-0.005)."""
    rng = np.random.default_rng(0)
    a = (np.abs(rng.normal(size=(512, 15 * 512))) * rng.normal(1.0, 1.0, size=(512, 1))
         ).astype(np.float32) * np.float32(2.0)
    b = (rng.normal(size=(15 * 512, 512)) * 0.004).astype(np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def _f32_matmul(x, y):
    return (torch.from_numpy(x) @ torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("mode", ["3xtf32", "tf32"])
def test_3xtf32_product_meets_k2_tolerance_where_tf32_does_not(mode):
    a, b, exact = _level4_product()
    ah, al = _split(a)
    bh, bl = _split(b)
    assert np.all((ah.view(np.uint32) & 0x1FFF) == 0) and np.all((al.view(np.uint32) & 0x1FFF) == 0)
    if mode == "3xtf32":
        # each TF32 x TF32 product is exact in f32; f32 accumulation
        got = _f32_matmul(al, bh) + _f32_matmul(ah, bl) + _f32_matmul(ah, bh)
    else:
        got = _f32_matmul(ah, bh)
    ok = np.abs(got - exact) <= 3e-5 + 1e-4 * np.abs(exact)
    assert np.abs(exact).max() > 1.0  # outputs of the size the forward gives
    if mode == "3xtf32":
        assert ok.all(), float(np.abs(got - exact).max())
    else:
        assert not ok.all()  # plain TF32 misses K2's tolerance: the check is not vacuous


def _rz(x):
    """float64 -> float32 rounded toward zero."""
    y = x.astype(np.float32)
    return np.where(np.abs(y) > np.abs(x), np.nextafter(y, np.float32(0)), y)


def _mma3_truncating(a, b, stage):
    """The kernels' 3xTF32 product with the tensor cores' additions
    emulated as truncating: each m16n8k8 step adds its 8 exact TF32
    products to its accumulator and rounds toward zero, in the kernels'
    order (lo hi, hi lo, hi hi). With ``stage``, each ``stage``-deep run of
    steps has its own accumulator, added to the total in f32 round to
    nearest (``gemm3_kernel``); without it, one accumulator takes the whole
    reduction."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (v.astype(np.float64) for v in (ah, al, bh, bl))
    k = a.shape[1]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    st = acc.copy()
    for k0 in range(0, k, 8):
        s = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            st = _rz(st + x[:, s] @ y[s])
        if stage and ((k0 + 8) % stage == 0 or k0 + 8 >= k):
            acc, st = acc + st, np.zeros_like(st)
    return acc if stage else st


def _dw_product():
    """K4's dW = weighted^T gs at level 0 (32768 queries deep): weighted rows
    of O(1) as in ``_level4_product``, a cotangent like chip_smoke's
    (standard deviation 1e-2), 64 weighted channels x 32 outputs."""
    rng = np.random.default_rng(1)
    k = 32768
    wtd = (np.abs(rng.normal(size=(k, 64))) * rng.normal(1.0, 1.0, size=(k, 1))
           ).astype(np.float32) * np.float32(2.0)
    gs = (rng.normal(size=(k, 32)) * 1e-2).astype(np.float32)
    a = np.ascontiguousarray(wtd.T)
    return a, gs, a.astype(np.float64) @ gs.astype(np.float64)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("product", ["k2_level4", "k4_dw"])
def test_truncating_mma_additions_need_stage_accumulators(product, staged):
    if product == "k2_level4":
        a, b, exact = _level4_product()
        # 64 x 64 outputs at the full reduction depth of 7680: each output's
        # error depends on its own reduction only
        a, b, exact, (atol, rtol) = a[:64], b[:, :64], exact[:64, :64], (3e-5, 1e-4)
    else:
        (a, b, exact), (atol, rtol) = _dw_product(), (5e-4, 1e-3)
    got = _mma3_truncating(a, b, 32 if staged else 0)
    ok = np.abs(got - exact) <= atol + rtol * np.abs(exact)
    if staged:
        assert ok.all(), float(np.abs(got - exact).max())
    else:
        assert not ok.all()  # truncation over the whole depth misses: the check is not vacuous
