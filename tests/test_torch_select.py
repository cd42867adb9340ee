"""K1: the port's band-select twin vs the JAX Pallas kernel in interpret
mode, on the same sorted level and the same tile windows: positions and
squared distances bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.select import band_select as j_band_select
from d3feat_tpu_torch.ops.neighbors import (
    SortedLevel, band_windows, pad_query_rows, tile_key_bounds)
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from d3feat_tpu_torch.ops.select import band_select, fma_f32
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax

# (name, query level, support level, radius in units of r_0, K, tile)
CASES = [("conv0", 0, 0, 1.0, 14, 256), ("pool0", 1, 0, 1.0, 14, 128),
         ("up0", 0, 1, 2.0, 1, 256), ("conv2", 2, 2, 4.0, 14, 128)]


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


@pytest.mark.parametrize("name,q_level,s_level,r_units,k,tile", CASES)
def test_select_twin_matches_pallas(name, q_level, s_level, r_units, k, tile):
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
    tpos, td2 = band_select(pad_query_rows(qb["q_rows"], tile), sb["s_rows"], ws, we,
                            query_tile=tile, r2=r * r, max_k=k)
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert np.array_equal(td2.numpy(), np.asarray(jd2))


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
