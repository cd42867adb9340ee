"""K3 detector-head band sums and their backward K5: kernel wrappers,
plain PyTorch twins, and the autograd function that joins them.

K3 ports ``d3feat_tpu/ops/pallas/head.py::band_head``: per sorted level-0
query, the sum of the feature rows of its neighbor list (recovered exactly
from the K1 thresholds over the tile's window) and the count of those rows
whose feature sum is non-zero. K5 ports ``_band_head_bwd_call``: the
transposed sum ``dx[r] = sum of g[q] over the queries q that list r``.

The kernels are ``ops/cuda/head.cu`` and ``ops/cuda/head_bwd.cu``;
``band_head_plain`` and ``band_head_bwd_plain`` are their twins, which
select from the windows. The kernels read the lists that conv0's list
stage built for the same search (``ops/band_lists.py``): K3 the lists, K5
their transpose, which K4's conv0 backward shares.
"""

from __future__ import annotations

import ctypes

import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.band_conv import threshold_select
from d3feat_tpu_torch.ops.band_lists import list_width
from d3feat_tpu_torch.ops.select import add_windows, tile_windows

C_MAX = 128  # channels per lane-strided warp in the kernel


def band_head_plain(q_rows, thr, ptie, s_rows, x, starts, wends, *, query_tile: int):
    """Twin of the K3 kernel (same contract), in plain PyTorch."""
    nq = q_rows.shape[0]
    n = nq // query_tile
    if n == 0:
        return q_rows.new_zeros((0, x.shape[1])), q_rows.new_zeros((0,))
    rows, pos, inside = tile_windows(s_rows, starts, wends)
    sel, _ = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)
    xw = x[pos] * inside[..., None]                    # [n, W, C]
    # rows summed one at a time in ascending position, the kernel's order
    fsum = q_rows.new_zeros((n, query_tile, x.shape[1]))
    for j in range(xw.shape[1]):
        fsum = fsum + torch.where(sel[:, :, j, None], xw[:, None, j], 0.0)
    active = xw.sum(-1) != 0.0
    cnt = (sel & active[:, None]).sum(-1).float()
    return fsum.reshape(nq, -1), cnt.reshape(nq)


_HEAD_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p] * 4


def band_head_kernel(x, lists):
    """Launch the K3 CUDA kernel: the contract of ``band_head_plain``,
    computed from the search's ``lists`` (``ops.band_lists.BandLists`` of
    the same queries, thresholds and windows), which the thresholds select."""
    build.require(x, torch.float32, "x")
    build.require(lists.lpos, torch.int32, "lpos")
    build.require(lists.lcnt, torch.int32, "lcnt")
    nq = lists.lcnt.shape[0]
    c = x.shape[1]
    if nq % 8 or lists.lpos.shape != (nq, list_width(lists.width)) or c > C_MAX:
        raise ValueError("band_head: bad list/shape arguments")
    ns = x.shape[0]
    flag = torch.empty((ns,), dtype=torch.uint8, device=x.device)  # rows with a non-zero sum
    fsum = torch.empty((nq, c), dtype=torch.float32, device=x.device)
    cnt = torch.empty((nq,), dtype=torch.float32, device=x.device)
    fn = build.launcher("head", "band_head_launch", _HEAD_ARGS)
    rc = fn(build.ptr(lists.lpos), build.ptr(lists.lcnt), lists.width, build.ptr(x), nq, ns, c,
            build.ptr(flag), build.ptr(fsum), build.ptr(cnt), build.stream_of(x))
    build.check(rc, "band_head_kernel")
    band_head.launches += 1
    return fsum, cnt


def band_head(q_rows, thr, ptie, s_rows, x, starts, wends, *, query_tile: int,
              impl: str = "auto", lists=None):
    """(fsum [Nq_pad, C] float32, cnt [Nq_pad] float32): per-query sums of
    the listed feature rows and the count of listed non-zero rows.
    Arguments as in ``ops.band_conv.band_conv``: the twin selects from the
    windows, the kernel reads the search's ``lists`` (kernels only)."""
    if not build.uses_kernel(impl, q_rows):
        return band_head_plain(q_rows, thr, ptie, s_rows, x, starts, wends,
                               query_tile=query_tile)
    if lists is None:
        raise ValueError("band_head kernel: no lists (ops.band_lists.band_lists of conv0)")
    if lists.lcnt.shape[0] != q_rows.shape[0] or x.shape[0] != s_rows.shape[0]:
        raise ValueError("band_head: lists or features of another search")
    return band_head_kernel(x, lists)


band_head.launches = 0


def band_head_bwd_plain(q_rows, thr, ptie, s_rows, g, starts, wends, *, query_tile: int):
    """Twin of the K5 kernel (same contract), in plain PyTorch: per tile,
    each window row's sum over the tile's queries in ascending order, then
    the tiles added in ascending order (the kernel's order, bit for bit)."""
    nq, c = g.shape
    n = nq // query_tile
    if n == 0:
        return g.new_zeros((s_rows.shape[0], c))
    rows, pos, inside = tile_windows(s_rows, starts, wends)
    sel, _ = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)  # [n, T, W]
    gt = g.view(n, query_tile, c)
    part = g.new_zeros((n, rows.shape[1], c))
    for j in range(query_tile):
        part = part + torch.where(sel[:, j, :, None], gt[:, j, None, :], 0.0)
    return add_windows(part, pos, inside, s_rows.shape[0])


_HEAD_BWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def band_head_bwd_kernel(g, row_ptr, pairs, query_tile: int, width: int):
    """Launch the K5 CUDA kernel: the contract of ``band_head_bwd_plain``,
    computed from the transpose (``row_ptr``, ``pairs``) of the search's
    lists (``ops.band_lists.transpose_lists``), ``width`` entries a query."""
    build.require(g, torch.float32, "g")
    build.require(row_ptr, torch.int32, "row_ptr")
    build.require(pairs, torch.int32, "pairs")
    nq, c = g.shape
    ns = row_ptr.shape[0] - 1
    if (nq % query_tile or width != list_width(width) or pairs.shape != (nq * width,)
            or c > C_MAX):
        raise ValueError("band_head_bwd: bad tile/shape arguments")
    dx = torch.empty((ns, c), dtype=torch.float32, device=g.device)
    fn = build.launcher("head_bwd", "band_head_bwd_launch", _HEAD_BWD_ARGS)
    rc = fn(build.ptr(row_ptr), build.ptr(pairs), build.ptr(g), ns, query_tile, c, width,
            build.ptr(dx), build.stream_of(g))
    build.check(rc, "band_head_bwd_kernel")
    band_head_bwd.launches += 1
    return dx


def band_head_bwd(q_rows, thr, ptie, s_rows, g, starts, wends, *, query_tile: int,
                  impl: str = "auto", lists=None):
    """dx [Ns_pad, C] float32: the cotangent of ``band_head``'s sums
    ``g`` [Nq_pad, C] carried back to the support rows. ``impl`` and
    ``lists`` as in ``band_head``: the kernel reads the lists' transpose,
    built once and shared with K4's conv0 backward."""
    if not build.uses_kernel(impl, q_rows):
        return band_head_bwd_plain(q_rows, thr, ptie, s_rows, g, starts, wends,
                                   query_tile=query_tile)
    if lists is None:
        raise ValueError("band_head_bwd kernel: no lists (ops.band_lists.band_lists of conv0)")
    if lists.lcnt.shape[0] != q_rows.shape[0] or g.shape[0] != q_rows.shape[0]:
        raise ValueError("band_head_bwd: lists or cotangent of another search")
    row_ptr, pairs = lists.transpose(s_rows.shape[0], impl="kernel")
    return band_head_bwd_kernel(g, row_ptr, pairs, query_tile, lists.width)


band_head_bwd.launches = 0


class BandHeadFn(torch.autograd.Function):
    """``band_head`` with K5 as its backward (port of
    ``d3feat_tpu/ops/pallas/head.py::band_head_ad``): differentiable in
    ``x``; the count is piecewise constant, its cotangent is dropped.

    ``apply(x, args, impl)`` with ``args`` the keyword arguments of
    ``band_head`` besides ``x`` (``models.kpfcnn.band_head_inputs``, with
    conv0's ``lists`` on the kernel path, which the forward reads and the
    backward reads transposed)."""

    @staticmethod
    def forward(ctx, x, args, impl):
        fsum, cnt = band_head(x=x, impl=impl, **args)
        ctx.args, ctx.impl = args, impl
        ctx.mark_non_differentiable(cnt)
        return fsum, cnt

    @staticmethod
    def backward(ctx, g_fsum, g_cnt):
        a = ctx.args
        dx = band_head_bwd(a["q_rows"], a["thr"], a["ptie"], a["s_rows"],
                           g_fsum.float().contiguous(), a["starts"], a["wends"],
                           query_tile=a["query_tile"], impl=ctx.impl, lists=a.get("lists"))
        return dx, None, None
