"""K1: the port's band-select twin vs the JAX Pallas kernel in interpret
mode, on the same sorted level and the same tile windows: positions and
squared distances bit for bit.

The CUDA kernel's algorithm (``ops/cuda/select.cu``) emulated step by step
on the CPU (``emulate_select``): the CTA split of ``select_block``, 64-bit
keys ``(bits(d2) << 32) | position``, 32-row steps skipped by a ballot
against the current K-th key, and each new key inserted into a sorted list
spread over the 32 lanes, two slots a lane (four above K = 64, eight above
128: the wide lists of deformable convs' doubled radii). The emulation is
held bit for bit against the twin and the JAX kernel on the pyramid's
searches, on duplicated support points (equal d2, ordered by position) and
on windows that a radius covers whole (candidates far beyond K, as at the
deep levels)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.select import band_select as j_band_select
from d3feat_tpu_torch.ops.neighbors import (
    SortedLevel, band_windows, pad_query_rows, tile_key_bounds)
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from d3feat_tpu_torch.ops.select import (
    EMPTY_D2, KMAX, band_select, exact_d2, fma_f32, select_block, select_plain, select_slots)
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

# (name, query level, support level, radius in units of r_0, K, tile)
CASES = [("conv0", 0, 0, 1.0, 14, 256), ("pool0", 1, 0, 1.0, 14, 128),
         ("up0", 0, 1, 2.0, 1, 256), ("conv2", 2, 2, 4.0, 14, 128)]

# (padded queries, tile) of the 13 searches of the bench pyramid, capacities
# 2 x (16384, 8192, 2048, 768, 256): conv and upsample searches at tile 256,
# pool searches at 128
BENCH_SEARCHES = sorted({(n, 256) for n in (32768, 16384, 4096, 1536, 512)}
                        | {(n, 128) for n in (16384, 4096, 1536, 512)})

NONE = np.uint64(0xFFFFFFFFFFFFFFFF)
CHUNK = 256  # window rows per shared-memory stage (window_stage.cuh)


def pack_keys(d2, pos, cand):
    """The kernel's 64-bit keys: ``(bits(d2) << 32) | pos`` for candidates,
    ``NONE`` for every other row."""
    bits = np.asarray(d2, np.float32).view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | np.asarray(pos, np.uint64)
    return np.where(cand, keys, NONE)


def insert_key(v, x):
    """One insertion into the sorted list of 32 S slots spread over 32 lanes
    (lane l holds slots S l + h in ``v[l, h]``): every slot takes its
    predecessor, the new key or itself, the lane's first slot from the
    previous lane's last (one shuffle); the last slot drops out."""
    prev = np.roll(v[:, -1], 1)
    prev[0] = 0  # slot 0 has no predecessor
    new = v.copy()
    for h in range(v.shape[1] - 1, 0, -1):
        new[:, h] = np.where(x < v[:, h - 1], v[:, h - 1], np.where(x < v[:, h], x, v[:, h]))
    new[:, 0] = np.where(x < prev, prev, np.where(x < v[:, 0], x, v[:, 0]))
    return new


def emulate_select(q_rows, s_rows, starts, wends, *, query_tile, r2, max_k, qb=None):
    """The K1 kernel's algorithm on the CPU (same contract as ``select_plain``),
    with ``qb`` queries per CTA (``select_block``'s choice by default)."""
    nq = q_rows.shape[0]
    empty = s_rows.shape[0] - 1
    out_pos = np.full((nq, max_k), empty, np.int32)
    out_d2 = np.full((nq, max_k), EMPTY_D2, np.float32)
    qb = qb or select_block(nq, query_tile, max_k)
    assert query_tile % qb == 0 and max_k <= KMAX
    S = select_slots(max_k)
    r2 = np.float32(r2)
    for cta in range(nq // qb):
        q0 = cta * qb
        t = q0 // query_tile  # the CTA's queries share one tile's window
        ws, we = int(starts[t]), int(wends[t])
        pos = np.arange(ws, max(ws, we))
        rows = s_rows[torch.from_numpy(pos).long()]
        for qi in range(q0, q0 + qb):
            q = q_rows[qi]
            d2 = exact_d2(rows, q[None]).numpy()
            cand = (rows[:, 3] == q[3]).numpy() & (d2 <= r2)
            keys = pack_keys(d2, pos, cand)
            v = np.full((32, S), NONE)
            kth = NONE
            for base in range(ws, we, CHUNK):            # staged chunks
                for j0 in range(base, min(base + CHUNK, we), 32):   # 32-row steps
                    step = np.full(32, NONE)
                    blk = keys[j0 - ws:min(j0 + 32, we) - ws]
                    step[:len(blk)] = blk
                    if max_k == 1:
                        v[:, 0] = np.minimum(v[:, 0], step)
                        continue
                    for b in np.nonzero(step < kth)[0]:  # ballot, lowest lane first
                        v = insert_key(v, step[b])
                    kth = v[(max_k - 1) // S, (max_k - 1) % S]
            slots = np.array([v[:, 0].min()]) if max_k == 1 else v.reshape(-1)
            for k, key in enumerate(slots[:max_k]):
                if key != NONE:
                    out_pos[qi, k] = int(key & np.uint64(0xFFFFFFFF))
                    out_d2[qi, k] = np.uint32(key >> np.uint64(32)).view(np.float32)
    return torch.from_numpy(out_pos), torch.from_numpy(out_d2)


def _inputs(q_level, s_level, r_units, tile):
    jcfg, _, pyr = jax_pyramid(3)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    qb, sb = batch["band"][q_level], batch["band"][s_level]
    rt = torch.tensor(jcfg.first_subsampling_dl * jcfg.conv_radius * r_units,
                      dtype=torch.float32)
    kmin, kmax = tile_key_bounds(qb["key_sorted"], tile, 2)
    starts = torch.searchsorted(sb["key_sorted"], kmin - (rt + SortedLevel.EPS))
    ends = torch.searchsorted(sb["key_sorted"], kmax + (rt + SortedLevel.EPS))
    ns = sb["key_sorted"].shape[0]
    ratio = -(-ns // qb["key_sorted"].shape[0])
    band_cap = level_band_cap(ns, 2, 0.1, tile=tile, ratio=ratio)
    return pyr, qb, sb, rt, starts, ends, band_cap


@functools.lru_cache(maxsize=None)
def _case(q_level, s_level, r_units, k, tile):
    """(port arguments of the search, JAX kernel's positions and d2)."""
    pyr, qb, sb, r, starts, ends, band_cap = _inputs(q_level, s_level, r_units, tile)
    q_packed = np.asarray(pyr["band"][q_level]["q_packed"])
    pad = (-q_packed.shape[1]) % tile
    if pad:
        q_packed = np.pad(q_packed, ((0, 0), (0, pad)))
        q_packed[3, -pad:] = -1.0
    jpos, jd2 = j_band_select(
        jnp.asarray(q_packed), jnp.asarray(pyr["band"][s_level]["s_packed"]),
        jnp.asarray(((starts // 8) * 8).numpy().astype(np.int32)), np.float32(r * r),
        jnp.asarray(ends.numpy().astype(np.int32)), max_k=k, band_cap=band_cap,
        query_tile=tile, interpret=True, with_dists=True)
    ws, we = band_windows(starts, ends, band_cap)
    args = (pad_query_rows(qb["q_rows"], tile), sb["s_rows"], ws, we)
    return args, dict(query_tile=tile, r2=r * r, max_k=k), np.asarray(jpos), np.asarray(jd2)


@pytest.mark.parametrize("name,q_level,s_level,r_units,k,tile", CASES)
def test_select_twin_matches_pallas(name, q_level, s_level, r_units, k, tile):
    args, kw, jpos, jd2 = _case(q_level, s_level, r_units, k, tile)
    tpos, td2 = band_select(*args, **kw)
    assert np.array_equal(tpos.numpy(), jpos)
    assert np.array_equal(td2.numpy(), jd2)


@pytest.mark.parametrize("qb", [None, 32])
@pytest.mark.parametrize("name,q_level,s_level,r_units,k,tile", CASES)
def test_select_kernel_emulation_matches_twin_and_pallas(name, q_level, s_level, r_units, k,
                                                          tile, qb):
    args, kw, jpos, jd2 = _case(q_level, s_level, r_units, k, tile)
    epos, ed2 = emulate_select(*args, **kw, qb=qb)
    ppos, pd2 = select_plain(*args, **kw)
    assert torch.equal(epos, ppos) and torch.equal(ed2, pd2)
    assert np.array_equal(epos.numpy(), jpos) and np.array_equal(ed2.numpy(), jd2)
    assert int((epos < args[1].shape[0] - 1).sum()) > 2 * args[0].shape[0] * (k > 1)


def _grid_level(seed, n_s=300, n_q=200, tile=128, cap=512):
    """Unsorted synthetic rows on a coarse grid: every support point is
    duplicated (equal d2 at two positions), and points of both clouds mix.
    (q_rows [Nq_pad, 4], s_rows [cap, 4], starts, wends, q_packed, s_packed)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 6, size=(n_s // 2, 3)).astype(np.float32) * np.float32(0.05)
    cid = rng.integers(0, 2, size=n_s // 2).astype(np.float32)
    s = np.concatenate([np.c_[pts, cid]] * 2)[rng.permutation(n_s)]
    s_rows = np.full((cap, 4), 1.0e6, np.float32)
    s_rows[:, 3] = 2.0
    s_rows[:n_s] = s
    nq_pad = -(-n_q // tile) * tile
    q_rows = np.zeros((nq_pad, 4), np.float32)
    q_rows[:, 3] = -1.0
    q_rows[:n_q, :3] = rng.integers(0, 6, size=(n_q, 3)).astype(np.float32) * np.float32(0.05)
    q_rows[:n_q, 3] = rng.integers(0, 2, size=n_q)
    n_tiles = nq_pad // tile
    starts = torch.zeros(n_tiles, dtype=torch.int32)
    ws, we = band_windows(starts, torch.full((n_tiles,), n_s, dtype=torch.int32), cap)
    q_packed = np.zeros((8, nq_pad), np.float32)
    q_packed[:4] = q_rows.T
    s_packed = np.zeros((cap, 128), np.float32)
    s_packed[:, :4] = s_rows
    return torch.from_numpy(q_rows), torch.from_numpy(s_rows), ws, we, q_packed, s_packed


# (radius, K): ties inside a radius that leaves lists short of K; radii that
# cover the whole 6 x 6 x 6 grid, so each query has ~150 candidates
GRID_CASES = [(0.075, 14), (0.075, 40), (1.0, 14), (1.0, 40), (1.0, 64), (1.0, 1),
              (1.0, 100), (1.0, 200)]


@pytest.mark.parametrize("r,k", GRID_CASES)
def test_select_emulation_on_ties_and_overfull_windows(r, k):
    q_rows, s_rows, ws, we, q_packed, s_packed = _grid_level(7)
    r2 = np.float32(r) * np.float32(r)
    kw = dict(query_tile=128, r2=r2, max_k=k)
    epos, ed2 = emulate_select(q_rows, s_rows, ws, we, **kw)
    ppos, pd2 = select_plain(q_rows, s_rows, ws, we, **kw)
    assert torch.equal(epos, ppos) and torch.equal(ed2, pd2)
    jpos, jd2 = j_band_select(jnp.asarray(q_packed), jnp.asarray(s_packed),
                              jnp.asarray(ws.numpy()), r2, jnp.asarray(we.numpy()), max_k=k,
                              band_cap=512, query_tile=128, interpret=True, with_dists=True)
    assert np.array_equal(epos.numpy(), np.asarray(jpos))
    assert np.array_equal(ed2.numpy(), np.asarray(jd2))
    d2 = ed2.numpy()[:200]
    ties = (d2[:, 1:] == d2[:, :-1]) & (d2[:, 1:] < EMPTY_D2)
    assert ties.any() or k == 1  # equal distances, ordered by position
    if r == 1.0 and 1 < k <= 100:  # the radius covers the grid: every list is full
        assert (d2 < EMPTY_D2).all()
    if k == 200:  # ~150 candidates a query: lists end short of K
        assert (d2 == EMPTY_D2).any(1).all() and (d2[:, 100] < EMPTY_D2).all()


def test_key_order_is_distance_then_position():
    rng = np.random.default_rng(0)
    n = 20000
    d2 = np.concatenate([
        rng.uniform(0.0, 1.0, n).astype(np.float32),
        rng.choice(np.float32([0.0, 3.0e38, 1e-45, 1.0, 0.5]), n),   # repeats, 0, 3e38, subnormal
        (rng.uniform(0.0, 1.0, n) ** 8).astype(np.float32)])
    pos = rng.permutation(len(d2)).astype(np.int64)                    # distinct positions
    keys = pack_keys(d2, pos, np.ones(len(d2), bool))
    assert np.array_equal(np.argsort(keys, kind="stable"), np.lexsort((pos, d2)))
    assert (keys < NONE).all()
    assert pack_keys(np.float32([0.0]), [5], [False])[0] == NONE


@pytest.mark.parametrize("nq,tile", BENCH_SEARCHES)
def test_select_block_spreads_every_bench_search(nq, tile):
    qb = select_block(nq, tile)
    assert qb in (2, 8, 32) and tile % qb == 0
    assert nq // qb >= 256  # CTAs: the deep searches spread over the card too
    # one query a warp for the wide lists (four or eight slots a lane)
    assert select_block(nq, tile, 200) == min(qb, 8) and select_block(nq, tile, 64) == qb


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=200000).astype(np.float32) * s for s in (1.0, 1e-3, 1e-7))
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    # reference: exact rational sum rounded once, via Python's integer-exact Fraction
    from fractions import Fraction
    idx = rng.choice(len(a), 2000, replace=False)
    for i in idx:
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, i


def test_kernel_route_refuses_cpu_tensors():
    z = torch.zeros((256, 4))
    s = torch.zeros((8, 4))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        band_select(z, s, i, i, query_tile=256, r2=1.0, max_k=4, impl="kernel")
