"""Port vs JAX: the original-order searches (the JAX package's non-band
route), bit for bit against the JAX package jitted, as its pyramid runs
them (the radius a constant of the program, so XLA multiplies by the
grid's reciprocal radius as it does inside ``build_pyramid``).

(a) ``radius_neighbors`` (brute), ``radius_neighbors_banded``,
    ``radius_neighbors_grid`` and ``count_in_radius`` on two clouds padded
    to capacity: rows truncated at ``max_k``, duplicated points (equal
    distances, ranked by index), one empty cloud, no cloud at all, queries
    that are not the supports (a pool search), and the banded and grid
    overflow flags (a small ``band_cap`` and ``cell_capacity``);
(b) ``radius_neighbors_pallas`` (K1 on clouds that are not pre-sorted)
    through K1's twin against JAX's with the Pallas kernel in interpret
    mode, on the shapes of ``tests/test_pallas_select.py``;
(c) ``calibrate_caps`` against JAX's on two packed pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops import neighbors as J
from d3feat_tpu_torch.ops import neighbors as P
from tests.torch_port_helpers import jax_config, packed_pair, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

CAP = 512
TILE = 128


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _clouds(seed, n0, n1, dup=0, cap=CAP):
    """Two boxes of uniform points, padded to ``cap`` at 1e6; with ``dup``
    the first ``dup`` + 1 points of each cloud coincide."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        rng.uniform(0, 1, size=(n0, 3)) * np.array([3.0, 1.0, 0.6]),
        rng.uniform(0, 1, size=(n1, 3)) * np.array([0.8, 2.5, 1.0]),
    ]).astype(np.float32)
    if dup:
        for start, n in ((0, n0), (n0, n1)):
            if n > dup:
                pts[start + 1:start + dup + 1] = pts[start]
    out = np.full((cap, 3), 1.0e6, np.float32)
    out[:n0 + n1] = pts
    return out, np.array([n0, n1], np.int32)


def _every_third(pts, lens, cap=256):
    """A coarser query set in the stacked layout: every third point of each
    cloud (the shape of a pool search's queries)."""
    parts, out_lens, at = [], [], 0
    for n in lens:
        parts.append(pts[at:at + n][::3])
        out_lens.append(len(parts[-1]))
        at += n
    out = np.full((cap, 3), 1.0e6, np.float32)
    q = np.concatenate(parts) if parts else np.zeros((0, 3), np.float32)
    out[:len(q)] = q
    return out, np.array(out_lens, np.int32)


CASES = {
    # name: (seed, n0, n1, dup, radius, max_k, pool queries)
    "truncated": (0, 200, 170, 0, 0.5, 10, False),
    "duplicates": (1, 250, 250, 6, 0.3, 16, False),
    "one_empty_cloud": (2, 300, 0, 3, 0.4, 12, False),
    "no_points": (3, 0, 0, 0, 0.4, 8, False),
    "pool_queries": (4, 230, 200, 4, 0.45, 14, True),
    "lattice": None,  # _lattice
}


def _lattice(offset=0.0):
    """A 9 x 9 x 5 lattice of spacing 0.05 in two clouds, padded: many
    pairs at exactly the lattice spacing and equal expansions (ties)."""
    g = np.arange(9, dtype=np.float32) * np.float32(0.05)
    lat = np.stack(np.meshgrid(g, g, g[:5], indexing="ij"), -1).reshape(-1, 3) + offset
    pts = np.full((CAP, 3), 1.0e6, np.float32)
    pts[:405] = lat
    return pts, np.array([250, 155], np.int32)


def _inputs(case):
    if case == "lattice":  # neighbours at the radius, equal distances, truncated rows
        s, sl = _lattice(3.0)
        return s, s, sl, sl, 0.071, 12
    seed, n0, n1, dup, r, k, pool = CASES[case]
    s, sl = _clouds(seed, n0, n1, dup)
    q, ql = _every_third(s, sl) if pool else (s, sl)
    return q, s, ql, sl, r, k


def _jit(fn, r, **kw):
    return jax.jit(lambda q, s, ql, sl: fn(q, s, ql, sl, r, num_clouds=2, **kw))


def _both(jfn, pfn, case, **kw):
    q, s, ql, sl, r, k = _inputs(case)
    if jfn is not J.count_in_radius:
        kw["max_k"] = k
    jout = _jit(jfn, r, **kw)(*(jnp.asarray(a) for a in (q, s, ql, sl)))
    pout = pfn(*(_t(a) for a in (q, s, ql, sl)), r, num_clouds=2, **kw)
    return jax.tree.map(np.asarray, jout), pout


@pytest.mark.parametrize("case", sorted(CASES))
def test_brute_search_bit_for_bit(case):
    jout, pout = _both(J.radius_neighbors, P.radius_neighbors, case, query_tile=TILE)
    assert pout.dtype == torch.int32
    assert np.array_equal(pout.numpy(), jout)


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_search_bit_for_bit(case):
    (jidx, jov), (pidx, pov) = _both(J.radius_neighbors_banded, P.radius_neighbors_banded,
                                     case, query_tile=TILE, band_cap=256)
    assert np.array_equal(pidx.numpy(), jidx)
    assert bool(pov) == bool(jov)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_search_bit_for_bit(case):
    (jidx, jov), (pidx, pov) = _both(J.radius_neighbors_grid, P.radius_neighbors_grid,
                                     case, query_tile=TILE, cell_capacity=16)
    assert np.array_equal(pidx.numpy(), jidx)
    assert bool(pov) == bool(jov)


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_in_radius_bit_for_bit(case):
    jout, pout = _both(J.count_in_radius, P.count_in_radius, case, query_tile=TILE)
    assert np.array_equal(pout.numpy(), jout)


def test_overflow_flags():
    """A band narrower than the tiles' windows and cells fuller than their
    capacity raise the flags on both stacks, with the same (truncated)
    lists."""
    (jidx, jov), (pidx, pov) = _both(J.radius_neighbors_banded, P.radius_neighbors_banded,
                                     "duplicates", query_tile=TILE, band_cap=128)
    assert bool(jov) and bool(pov)
    assert np.array_equal(pidx.numpy(), jidx)
    (jidx, jov), (pidx, pov) = _both(J.radius_neighbors_grid, P.radius_neighbors_grid,
                                     "duplicates", query_tile=TILE, cell_capacity=4)
    assert bool(jov) and bool(pov)
    assert np.array_equal(pidx.numpy(), jidx)
    _, (_, pov) = _both(J.radius_neighbors_banded, P.radius_neighbors_banded, "duplicates",
                        query_tile=TILE, band_cap=512)
    assert not bool(pov)  # and a band as wide as the level does not overflow


def test_truncated_rows_and_ties_are_exercised():
    """The inputs reach what the bit-for-bit tests must cover: rows with
    more supports in radius than ``max_k`` and rows with equal distances."""
    q, s, ql, sl, r, k = _inputs("truncated")
    counts = P.count_in_radius(_t(q), _t(s), _t(ql), _t(sl), r, num_clouds=2).numpy()
    assert (counts > k).sum() > 50
    q, s, ql, sl, r, k = _inputs("duplicates")
    idx = P.radius_neighbors(_t(q), _t(s), _t(ql), _t(sl), r, max_k=k, num_clouds=2).numpy()
    assert set(range(7)) <= set(idx[0].tolist())  # the 7 coincident points, by index


@pytest.mark.parametrize("seed,overflow", [(0, False), (3, False), (5, True)])
def test_pallas_unsorted_twin_matches_jax_interpret(seed, overflow):
    if overflow:  # test_pallas_overflow_and_padding_rows: one tight cloud
        rng = np.random.default_rng(seed)
        s = np.full((CAP, 3), 1.0e6, np.float32)
        s[:300] = rng.uniform(0, 1, size=(300, 3)) * 0.05
        sl = np.array([300, 0], np.int32)
        r, k, band_cap = 0.1, 8, 128
    else:
        s, sl = _clouds(seed, 200, 170, dup=3)
        r, k, band_cap = 0.5, 10, 512
    kw = dict(max_k=k, num_clouds=2, query_tile=64, band_cap=band_cap)
    jidx, jov = J.radius_neighbors_pallas(jnp.asarray(s), jnp.asarray(s), jnp.asarray(sl),
                                          jnp.asarray(sl), r, interpret=True, **kw)
    pidx, pov = P.radius_neighbors_pallas(_t(s), _t(s), _t(sl), _t(sl), r, **kw)
    assert np.array_equal(pidx.numpy(), np.asarray(jidx))
    assert bool(pov) == bool(jov) == overflow
    if not overflow:  # within the band, the same lists as the banded search
        bidx, _ = P.radius_neighbors_banded(_t(s), _t(s), _t(sl), _t(sl), r, max_k=k,
                                            num_clouds=2, query_tile=64, band_cap=band_cap)
        assert torch.equal(bidx, pidx)


def test_calibrate_caps_matches_jax():
    from d3feat_tpu.data.calibrate import calibrate_caps as j_calibrate
    from d3feat_tpu_torch.data.calibrate import calibrate_caps

    jcfg = jax_config(3)
    pairs = []
    for seed in (3, 5):
        pts, _, lens = packed_pair(seed)
        pairs.append({"points": pts, "lengths": lens})
    jcaps = j_calibrate(pairs, jcfg)
    pcaps = calibrate_caps(pairs, torch_config(jcfg), device="cpu")
    assert pcaps.points == tuple(jcaps.points)
    assert pcaps.neighbors == tuple(jcaps.neighbors)
    assert pcaps.corr == jcaps.corr


def _fma_two_sum(a, b, c):
    """float32 ``a * b + c`` rounded once, by TwoSum on every entry: the
    float64 sum made round-to-odd by its rounding error."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def test_fma_rn_is_fma_f32():
    """``fma_f32``, the searches' round-to-nearest multiply-add (float64
    sum, rounded, ties redone), equals TwoSum on every entry bit for bit:
    random operands, broadcast operands, cancellations, zeros of either
    sign, subnormal results, and a sum whose float64 rounding lands halfway
    between two float32 values."""
    from d3feat_tpu_torch.ops.select import fma_f32

    g = torch.Generator().manual_seed(1)
    for scale in (1.0, 1e-20, 1e-39):
        a = torch.randn(200_000, generator=g) * scale
        b = torch.randn(200_000, generator=g)
        for c in (torch.randn(200_000, generator=g) * scale,
                  (-(a.double() * b.double())).float(), torch.zeros(200_000),
                  -torch.zeros(200_000)):
            assert torch.equal(fma_f32(a, b, c).view(torch.int32),
                               _fma_two_sum(a, b, c).view(torch.int32))
        a2, b2, c2 = a[:400].reshape(20, 1, 20), b[:30].reshape(30, 1), c[:20]
        assert torch.equal(fma_f32(a2, b2, c2).view(torch.int32),
                           _fma_two_sum(a2, b2, c2).view(torch.int32))
    a = torch.tensor([1 + 2**-23])
    b = torch.tensor([(1 - 2**-23) * 2**-24])
    c = torch.tensor([1 + 2**-23])
    naive = (a.double() * b.double() + c.double()).float()
    assert not torch.equal(naive, _fma_two_sum(a, b, c))  # the tie the float64 sum decides wrongly
    assert torch.equal(fma_f32(a, b, c), _fma_two_sum(a, b, c))


def test_fma_f32_corrects_every_entry():
    """Every entry a sum whose float64 rounding lands halfway between two
    float32 values (below it or above it, either sign, exponents from
    2^-10 to 2^10) or in float32's subnormal range, so the branch-free
    correction decides each: equal to TwoSum bit for bit, and not to the
    plain float64 sum rounded."""
    from d3feat_tpu_torch.ops.select import fma_f32

    g = torch.Generator().manual_seed(2)
    n = 50_000
    k = torch.randint(1, 300, (n,), generator=g).double() * 2.0**-23
    e = torch.randint(-10, 11, (n,), generator=g).double()
    base = (1.0 + torch.rand(n, generator=g, dtype=torch.float64)).float().double() * 2.0**e
    up = torch.rand(n, generator=g) < 0.5  # the exact sum just under or just over the tie
    sign = torch.where(torch.rand(n, generator=g) < 0.5, 1.0, -1.0).double()
    a = (1.0 + k).float()
    b = torch.where(up, -1.0, 1.0).double() * (1.0 - k) * 2.0**(e - 24)
    c = torch.where(up, base + 2.0**(e - 23), base)
    a, b, c = a * sign.float(), b.float(), (c * sign).float()
    tiny = torch.randn(3, n, generator=g) * torch.tensor([[1e-20], [1e-20], [1e-39]])
    a, b, c = (torch.cat([x, t]) for x, t in zip((a, b, c), tiny))
    s = a.double() * b.double() + c.double()
    tie = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    assert bool(torch.all(tie[:n])) and bool(torch.all(s[n:].abs() < 2.0**-125))
    got = fma_f32(a, b, c)
    assert torch.equal(got.view(torch.int32), _fma_two_sum(a, b, c).view(torch.int32))
    assert int((got != s.float())[:n].sum()) > n // 3


@pytest.mark.parametrize("n", [1, 3, 32, 33, 220, 512, 1025, 4000])
def test_sum_rows_is_xla_column_sum(n):
    x = (np.random.default_rng(n).standard_normal((n, 3)) * 2 + 5).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(jnp.asarray(x)))
    assert np.array_equal(P.sum_rows(_t(x)).numpy(), want)


def test_smallest_k_is_lax_top_k():
    """Ties (and the 3e38 of other clouds) ranked lowest index first."""
    rng = np.random.default_rng(2)
    v = rng.integers(0, 6, size=(40, 300)).astype(np.float32) * np.float32(0.25) - 0.5
    v[:, ::7] = 3.0e38
    neg, idx = jax.lax.top_k(-jnp.asarray(v), 20)
    vals, sel = P.smallest_k(_t(v), 20)
    assert np.array_equal(sel.numpy(), np.asarray(idx))
    assert np.array_equal(vals.numpy(), -np.asarray(neg))


@pytest.mark.parametrize("offset", [0.0, 37.0])
def test_count_filter_decides_as_the_expansion(offset):
    """``count_in_radius`` decides most pairs from a float64 product and
    computes the float32 expansion only near the radius: on a lattice whose
    spacing is the radius (many pairs at exactly r, some a rounding away),
    far from the origin too, it counts what the float32 expansion computed
    for every pair counts, and what JAX counts."""
    pts, lens = _lattice(offset)
    r = 0.05
    got = P.count_in_radius(_t(pts), _t(pts), _t(lens), _t(lens), r, num_clouds=2, query_tile=TILE)
    q = _t(pts)
    cid = P.lengths_to_cloud_ids(_t(lens), CAP)
    d2 = (P.dot3(q, q)[:, None] - 2.0 * P.dot3(q[:, None, :], q[None])) + P.dot3(q, q)[None]
    r2 = P.f32(P.f32(r) ** 2)
    full = ((cid[:, None] == cid[None, :]) & (cid[:, None] < 2) & (d2 <= r2)).sum(1)
    assert torch.equal(got.long(), full)
    want = _jit(J.count_in_radius, r, query_tile=TILE)(*(jnp.asarray(a) for a in (pts, pts, lens,
                                                                                 lens)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # neighbours at r on the lattice, counted or not by a rounding: both occur
    assert int((got[:405] > 1).sum()) > 100 and int((got[:405] < 6).sum()) > 100
