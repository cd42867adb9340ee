"""K3: the port's band-head twin vs the JAX Pallas kernel in interpret
mode on the same level-0 band: sums at atol 1e-6, counts exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.head import band_head as j_band_head
from d3feat_tpu_torch.models.blocks import band_query_tiles
from d3feat_tpu_torch.ops.head import band_head
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 8)])
def test_band_head_twin_matches_pallas(seed, c):
    jcfg, _, pyr = jax_pyramid(seed)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    b0 = batch["band"][0]
    s_rows = batch["points"][0].shape[0]
    thr, ptie = batch["sel_thr"]["conv0"]
    r0 = jcfg.first_subsampling_dl * jcfg.conv_radius
    q_rows, starts, ends, thr_p, ptie_p = band_query_tiles(b0, b0, 2, r0, 256, s_rows,
                                                           thr, ptie)
    band_cap = level_band_cap(s_rows, 2, 0.1, tile=256, ratio=1)
    rng = np.random.default_rng(seed + 11)
    x = np.zeros((b0["s_rows"].shape[0], c), np.float32)
    n = int(pyr["lengths"][0].sum())
    x[:n] = rng.uniform(0.0, 1.0, size=(n, c))
    x[2:n:9] = 0.0  # zero rows are listed but not counted

    q_packed = np.zeros((8, q_rows.shape[0]), np.float32)
    q_packed[:4] = q_rows.numpy().T
    q_packed[4], q_packed[5] = thr_p.numpy(), ptie_p.numpy()
    jsum, jcnt = j_band_head(jnp.asarray(q_packed), jnp.asarray(pyr["band"][0]["s_packed"]),
                             jnp.asarray(x), jnp.asarray(starts.numpy().astype(np.int32)),
                             jnp.asarray(ends.numpy().astype(np.int32)), band_cap=band_cap,
                             query_tile=256, interpret=True)
    ws, we = band_windows(starts, ends, band_cap)
    tsum, tcnt = band_head(q_rows, thr_p, ptie_p, b0["s_rows"], torch.from_numpy(x), ws, we,
                           query_tile=256)
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum)[:, :c], rtol=0, atol=1e-6)
    assert tcnt.max() > 1
