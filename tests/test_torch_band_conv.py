"""K2: the port's band-KPConv twin vs the JAX Pallas kernel (threshold
mode) in interpret mode, on the same sorted pyramid, windows, features and
weights: outputs at atol 3e-5 / rtol 1e-4 (the JAX suite's own band-conv
tolerance, tests/test_band_conv.py), density denominators exact. The
CUDA kernel's decomposition over the list stage's lists, emulated in plain
PyTorch, is held to the same tolerances."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.band_conv import band_conv as j_band_conv
from d3feat_tpu_torch.config import D3FeatConfig
from d3feat_tpu_torch.models.blocks import BlockSpec, band_query_tiles
from d3feat_tpu_torch.models.kernel_points import load_kernels
from d3feat_tpu_torch.ops.band_conv import band_conv
from d3feat_tpu_torch.ops.band_lists import band_lists
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import band_conv_from_lists, jax_pyramid, torch_batch_from_jax

# (search, support level, strided, cin, cout)
CASES = [("conv0", 0, False, 1, 8), ("conv0", 0, False, 16, 16),
         ("pool0", 0, True, 8, 8), ("conv3", 3, False, 32, 24)]


@functools.lru_cache(maxsize=None)
def _case(name, l, strided, cin, cout):
    """(port keyword arguments of ``band_conv``, x, W, kernel points, JAX
    out, JAX den) for one conv of the shared JAX pyramid."""
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
    extent = r * jcfg.KP_extent / jcfg.conv_radius

    rng = np.random.default_rng(7)
    ns_pad = sb["s_rows"].shape[0]
    x = np.zeros((ns_pad, cin), np.float32)
    nvalid = int(pyr["lengths"][l].sum())
    x[:nvalid] = rng.normal(size=(nvalid, cin))
    x[:nvalid:5] = np.abs(x[:nvalid:5])            # some rows positive, some zero
    x[1:nvalid:7] = 0.0
    w = rng.normal(size=(15, cin, cout)).astype(np.float32) * 0.3
    kp = load_kernels(r, 15)

    q_packed = np.zeros((8, q_rows.shape[0]), np.float32)
    q_packed[:4] = q_rows.numpy().T
    jout, jden = j_band_conv(
        jnp.asarray(q_packed), jnp.zeros((1, q_rows.shape[0]), jnp.int32),
        jnp.asarray(pyr["band"][l]["s_packed"]), jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(kp), jnp.asarray(starts.numpy().astype(np.int32)), jnp.float32(extent),
        jnp.asarray(ends.numpy().astype(np.int32)), jnp.asarray(thr_p.numpy()),
        jnp.asarray(ptie_p.numpy()), band_cap=band_cap, query_tile=tile, interpret=True)
    ws, we = band_windows(starts, ends, band_cap)
    port = dict(q_rows=q_rows.contiguous(), thr=thr_p, ptie=ptie_p, s_rows=sb["s_rows"],
                starts=ws, wends=we, query_tile=tile, extent=extent)
    return port, x, w, kp, np.asarray(jout), np.asarray(jden)[0]


@pytest.mark.parametrize("name,l,strided,cin,cout", CASES)
def test_band_conv_twin_matches_pallas(name, l, strided, cin, cout):
    port, x, w, kp, jout, jden = _case(name, l, strided, cin, cout)
    tout, tden = band_conv(x=torch.from_numpy(x), weights=torch.from_numpy(w),
                           kernel_points=torch.from_numpy(kp), **port)
    assert np.array_equal(tden.numpy(), jden)
    np.testing.assert_allclose(tout.numpy(), jout, atol=3e-5, rtol=1e-4)
    assert np.abs(jout).max() > 0.1  # the comparison is not vacuous


@pytest.mark.parametrize("name,l,strided,cin,cout", CASES)
def test_band_conv_from_lists_matches_pallas(name, l, strided, cin, cout):
    """The kernels' decomposition (lists, first product per query, density
    from the listed rows, then ``weighted W / den``) computes the TPU
    kernel's function: same tolerances as the twin."""
    port, x, w, kp, jout, jden = _case(name, l, strided, cin, cout)
    lists = band_lists(**{k: v for k, v in port.items() if k != "extent"})
    tout, tden, wtd = band_conv_from_lists(lists, port["q_rows"], port["s_rows"],
                                           torch.from_numpy(x), torch.from_numpy(w),
                                           torch.from_numpy(kp), port["extent"])
    assert wtd.shape == (port["q_rows"].shape[0], 15 * cin)
    assert np.array_equal(tden.numpy(), jden)
    np.testing.assert_allclose(tout.numpy(), jout, atol=3e-5, rtol=1e-4)
    assert np.abs(jout).max() > 0.1


def test_band_conv_eligibility_at_bench_config():
    """Every rigid KPConv of the default (r5) architecture fits the band
    kernel's panel budget, so the gather KPConv is off the serving path."""
    from d3feat_tpu_torch.models.blocks import band_conv_eligible
    from d3feat_tpu_torch.models.kpfcnn import make_kpfcnn_specs

    cfg = D3FeatConfig(experiment_id="x")
    batch = {"band": {l: {} for l in range(5)}}
    specs = make_kpfcnn_specs(cfg)
    convs = [s for s in specs.encoder if s.kind in ("simple", "resnetb")]
    assert len(convs) == 14
    assert all(band_conv_eligible(s, batch, cfg) for s in convs)
    deform = BlockSpec("resnetb_deformable", "resnetb", 1, 64, 64, 0.1, deformable=True)
    assert not band_conv_eligible(deform, batch, cfg)
