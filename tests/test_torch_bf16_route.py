"""The redesigned route of K2's and K4's bf16 panels (``band_products.cuh``,
``band_conv.cu``, ``band_conv_bwd.cu``), emulated on the CPU from the list
stage's lists by the helpers of ``tests/torch_port_helpers.py``, on the
inputs of ``tests/test_torch_bf16.py::_case`` (Cin = Cout = 16), against
the bf16 twins and JAX's bf16 panels (Pallas in interpret mode, computed
once for the file):

(a) the pieces of each list (the entries of one chunk of the window), found
    by a ballot over the lanes' chunk ids, equal the serial scan's bit for
    bit, at the band's chunk and at 64-row chunks where lists cross several
    chunks;
(b) K2's second product as one pass of each query's hi and lo rows
    against one stage of W, each into its own accumulators with the tensor
    cores' truncating additions in 32-deep stages, added at the end, over
    the first product emulated piece by piece (k-steps from each piece's
    first entry): within relative L2 1e-4 of the bf16 twin (the card's
    kernel-vs-twin bound) and 1e-2 of JAX's bf16 ``band_conv``;
(c) K4's dx by pairs (U = bf16 weights by V = bf16(gs W^T) for each listed
    pair, then each support row's sum in ascending pair order): 1e-4 of the
    twin's, 1e-2 of JAX's bf16 VJP;
(d) dW from the hi and the lo rows as two operands against one stage of gs
    (each into its own accumulators) within 1e-4 of [hi; lo]^T [gs; gs] in
    one accumulator over the doubled rows;
(e) V rounded in the product's epilogue equals the f32 product cast to
    bf16 afterwards, bit for bit.
"""

import numpy as np
import pytest
import torch

from d3feat_tpu_torch.ops.band_conv import band_conv
from d3feat_tpu_torch.ops.band_lists import band_lists
from tests.test_torch_bf16 import BOUND, TWIN_BOUND, _case, _grads, _jax_fwd, _jax_grads, rel_l2
from tests.torch_port_helpers import (bf16_rn, dx_by_pairs, mma_bf16_two_staged,
                                      piece_starts_ballot, piece_starts_serial,
                                      weighted_bf16_route)
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def conv():
    """The case, its lists, and JAX's bf16 forward and VJP (one JAX run each)."""
    jx, port, x, w, kp, cot = _case(16, 16)
    lists = band_lists(**{k: port[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts",
                                                "wends", "query_tile")})
    jout, _ = _jax_fwd(jx, x, w, kp, "bfloat16")
    jdx, jdw = _jax_grads(jx, x, w, kp, cot, "bfloat16")
    return dict(port=port, x=x, w=w, kp=kp, cot=cot, lists=lists, jout=jout, jdx=jdx, jdw=jdw)


def _window_starts(port):
    return port["starts"].long().repeat_interleave(port["query_tile"]).numpy()


def _hi_lo(c, chunk):
    p = c["port"]
    return weighted_bf16_route(c["lists"], p["q_rows"], p["s_rows"], torch.from_numpy(c["x"]),
                               torch.from_numpy(c["kp"]), p["extent"], chunk, p["starts"],
                               p["query_tile"])


def _den(c):
    return band_conv(x=torch.from_numpy(c["x"]), weights=torch.from_numpy(c["w"]),
                     kernel_points=torch.from_numpy(c["kp"]), panel_dtype="bfloat16",
                     **c["port"])[1].numpy()


@pytest.mark.parametrize("chunk", [None, 64])
def test_ballot_pieces_equal_the_serial_scan(conv, chunk):
    lists, port = conv["lists"], conv["port"]
    chunk = chunk or port["chunk"]
    args = (lists.lpos.numpy(), lists.lcnt.numpy(), _window_starts(port), chunk)
    serial, ballot = piece_starts_serial(*args), piece_starts_ballot(*args)
    assert np.array_equal(ballot, serial)
    pieces = serial.sum(1)
    assert pieces.max() >= (3 if chunk == 64 else 1) and (pieces[lists.lcnt.numpy() > 0] >= 1).all()


@pytest.mark.parametrize("chunk", [None, 64])
def test_k2_hi_lo_single_reduction_matches_twin_and_jax(conv, chunk):
    port = conv["port"]
    chunk = chunk or port["chunk"]
    hi, lo = _hi_lo(conv, chunk)
    kpn, c, cout = conv["w"].shape
    wb = bf16_rn(conv["w"].reshape(kpn * c, cout))
    out = mma_bf16_two_staged(hi, lo, wb) / _den(conv)[:, None]
    twin = band_conv(x=torch.from_numpy(conv["x"]), weights=torch.from_numpy(conv["w"]),
                     kernel_points=torch.from_numpy(conv["kp"]), panel_dtype="bfloat16",
                     **dict(port, chunk=chunk))[0].numpy()
    assert rel_l2(out, twin) < TWIN_BOUND, rel_l2(out, twin)
    assert rel_l2(out, conv["jout"]) < BOUND, rel_l2(out, conv["jout"])
    assert np.abs(out).max() > 0.1 and bool((lo != 0).any())  # not vacuous


def _gs(conv):
    g = np.zeros((conv["port"]["q_rows"].shape[0], conv["w"].shape[2]), np.float32)
    g[: conv["cot"].shape[0]] = conv["cot"]
    return g / _den(conv)[:, None]


def test_k4_dx_by_pairs_matches_twin_and_jax(conv):
    p = conv["port"]
    dx = dx_by_pairs(conv["lists"], p["q_rows"], p["s_rows"], torch.from_numpy(conv["w"]),
                     torch.from_numpy(conv["kp"]), torch.from_numpy(_gs(conv)), p["extent"])
    tdx, _ = _grads(p, conv["x"], conv["w"], conv["kp"], conv["cot"], "bfloat16")
    assert rel_l2(dx, tdx) < TWIN_BOUND, rel_l2(dx, tdx)
    assert rel_l2(dx, conv["jdx"]) < BOUND, rel_l2(dx, conv["jdx"])
    assert np.abs(dx).max() > 1e-2


def test_k4_dw_two_operands_match_the_doubled_rows(conv):
    hi, lo = _hi_lo(conv, conv["port"]["chunk"])
    gsb = bf16_rn(_gs(conv))
    new = mma_bf16_two_staged(np.ascontiguousarray(hi.T), np.ascontiguousarray(lo.T), gsb)
    old = mma_bf16_two_staged(np.concatenate([hi, lo]).T, None, np.concatenate([gsb, gsb]))
    assert rel_l2(new, old) < TWIN_BOUND, rel_l2(new, old)
    _, tdw = _grads(conv["port"], conv["x"], conv["w"], conv["kp"], conv["cot"], "bfloat16")
    assert rel_l2(new.reshape(tdw.shape), tdw) < TWIN_BOUND
    assert rel_l2(new.reshape(tdw.shape), conv["jdw"]) < BOUND


def test_v_rounded_in_the_epilogue_equals_the_cast_product(conv):
    kpn, c, cout = conv["w"].shape
    gsb = bf16_rn(_gs(conv))
    wb = bf16_rn(conv["w"].reshape(kpn * c, cout))
    vf = mma_bf16_two_staged(gsb, None, np.ascontiguousarray(wb.T))   # the f32 scratch before
    cast = torch.from_numpy(vf).to(torch.bfloat16).float().numpy()    # then to_bf16
    epilogue = bf16_rn(vf)                                             # __float2bfloat16_rn
    assert np.array_equal(epilogue.view(np.uint32), cast.view(np.uint32))
    assert not np.array_equal(epilogue, vf)  # the rounding is real
