"""K3: the port's band-head twin vs the JAX Pallas kernel in interpret
mode on the same level-0 band: sums at atol 1e-6, counts exact.

The CUDA kernel (``ops/cuda/head.cu``) reads conv0's lists where the twin
and the TPU kernel select from the windows; its route is emulated on the
CPU from the lists' twin (``head_from_lists``: each listed row added in
list order, a row counted when its lane-strided, xor-butterfly row sum is
non-zero) and held bit for bit against the twin and at the JAX tolerance
against the JAX kernel. The head's arguments are conv0's search arguments,
shared with the level-0 convs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.pallas.head import band_head as j_band_head
from d3feat_tpu_torch.models.blocks import band_conv_inputs, band_query_tiles
from d3feat_tpu_torch.models.kpfcnn import band_head_inputs, make_kpfcnn_specs
from d3feat_tpu_torch.ops.band_lists import band_lists_plain
from d3feat_tpu_torch.ops.head import band_head, band_head_plain
from d3feat_tpu_torch.ops.neighbors import band_windows
from d3feat_tpu_torch.ops.pyramid import level_band_cap
from tests.torch_port_helpers import jax_pyramid, torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def head_from_lists(lists, x):
    """The K3 kernel's route on the CPU: (fsum, cnt) from the search's lists,
    in float32 as the kernel rounds (one lane per channel, C <= 128)."""
    nq, c = lists.lcnt.shape[0], x.shape[1]
    lanes = np.zeros((x.shape[0], 4 * 32), np.float32)
    lanes[:, :c] = x.numpy()
    part = np.zeros((x.shape[0], 32), np.float32)
    for i in range(4):  # lane l adds channels l, l + 32, ... in turn
        part = part + lanes[:, 32 * i:32 * (i + 1)]
    for o in (16, 8, 4, 2, 1):  # xor butterfly
        part = part + part[:, np.arange(32) ^ o]
    counted = torch.from_numpy(part[:, 0] != 0.0)
    fsum = torch.zeros((nq, c), dtype=torch.float32)
    cnt = torch.zeros((nq,), dtype=torch.float32)
    pos = lists.lpos.clamp(min=0).long()
    for j in range(lists.lpos.shape[1]):  # listed rows in list order
        live = j < lists.lcnt
        fsum = torch.where(live[:, None], fsum + x[pos[:, j]], fsum)
        cnt = cnt + (live & counted[pos[:, j]]).float()
    return fsum, cnt


@functools.lru_cache(maxsize=None)
def _case(seed, c):
    """(twin arguments of the level-0 band, x, JAX kernel's sums and counts)."""
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
    args = dict(q_rows=q_rows, thr=thr_p, ptie=ptie_p, s_rows=b0["s_rows"], starts=ws,
                wends=we, query_tile=256)
    return args, torch.from_numpy(x), np.asarray(jsum)[:, :c], np.asarray(jcnt)


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 8)])
def test_band_head_twin_matches_pallas(seed, c):
    args, x, jsum, jcnt = _case(seed, c)
    tsum, tcnt = band_head(x=x, **args)
    assert np.array_equal(tcnt.numpy(), jcnt)
    np.testing.assert_allclose(tsum.numpy(), jsum, rtol=0, atol=1e-6)
    assert tcnt.max() > 1


@pytest.mark.parametrize("seed,c", [(3, 32), (5, 32), (3, 40)])
def test_band_head_list_route_matches_twin_and_pallas(seed, c):
    args, x, jsum, jcnt = _case(seed, c)
    lists = band_lists_plain(**args)
    lsum, lcnt = head_from_lists(lists, x)
    psum, pcnt = band_head_plain(x=x, **args)
    assert torch.equal(lsum, psum) and torch.equal(lcnt, pcnt)
    assert np.array_equal(lcnt.numpy(), jcnt)
    np.testing.assert_allclose(lsum.numpy(), jsum, rtol=0, atol=1e-6)
    assert int(lists.lcnt.sum()) > int(lcnt.sum()) > 4 * int((args["q_rows"][:, 3] >= 0).sum())


@pytest.mark.parametrize("seed", [3, 5])
def test_head_shares_conv0_search_arguments(seed):
    jcfg, _, pyr = jax_pyramid(seed)
    cfg = torch_config(jcfg)
    conv0 = make_kpfcnn_specs(cfg).encoder[0]
    assert (conv0.layer, conv0.strided) == (0, False)
    head = band_head_inputs(torch_batch_from_jax(pyr, np.zeros((512, 1))), cfg)
    batch = torch_batch_from_jax(pyr, np.zeros((512, 1)))
    conv = band_conv_inputs(conv0, batch, cfg)
    for k in ("q_rows", "thr", "ptie", "s_rows", "starts", "wends", "query_tile"):
        assert torch.equal(torch.as_tensor(head[k]), torch.as_tensor(conv[k])), k
    # built once per batch: the head takes the convs' arguments as they are
    again = band_head_inputs(batch, cfg)
    assert all(again[k] is conv[k] for k in ("q_rows", "thr", "ptie", "starts", "wends"))


def test_kernel_route_needs_lists_and_cuda():
    args, x, _, _ = _case(3, 32)
    with pytest.raises(ValueError, match="no lists"):
        band_head(x=x, impl="kernel", **args)
    with pytest.raises(ValueError, match="CUDA"):
        band_head(x=x, impl="kernel", lists=band_lists_plain(**args), **args)
