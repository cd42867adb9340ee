"""K3 detector-head band sums and their backward K5: kernel wrappers,
plain PyTorch twins, and the autograd function that joins them.

K3 ports ``d3feat_tpu/ops/pallas/head.py::band_head``: per sorted level-0
query, the sum of the feature rows of its neighbor list (recovered exactly
from the K1 thresholds over the tile's window) and the count of those rows
whose feature sum is non-zero. K5 ports ``_band_head_bwd_call``: the
transposed sum ``dx[r] = sum of g[q] over the queries q that list r``.

The kernels are ``ops/cuda/head.cu`` and ``ops/cuda/head_bwd.cu``;
``band_head_plain`` and ``band_head_bwd_plain`` are their twins.
"""

from __future__ import annotations

import ctypes

import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.band_conv import threshold_select
from d3feat_tpu_torch.ops.select import add_windows, covering_tiles, tile_windows

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


def band_head_kernel(q_rows, thr, ptie, s_rows, x, starts, wends, *, query_tile: int):
    """Launch the K3 CUDA kernel (same contract as ``band_head_plain``)."""
    f32, i32 = torch.float32, torch.int32
    for t, dt, name in ((q_rows, f32, "q_rows"), (thr, f32, "thr"), (ptie, f32, "ptie"),
                        (s_rows, f32, "s_rows"), (x, f32, "x"), (starts, i32, "starts"),
                        (wends, i32, "wends")):
        build.require(t, dt, name)
    nq = q_rows.shape[0]
    c = x.shape[1]
    if (nq % query_tile or query_tile % 8 or starts.shape[0] != nq // query_tile
            or x.shape[0] != s_rows.shape[0] or c > C_MAX):
        raise ValueError("band_head: bad tile/shape arguments")
    fsum = torch.empty((nq, c), dtype=f32, device=q_rows.device)
    cnt = torch.empty((nq,), dtype=f32, device=q_rows.device)
    fn = build.load("head").band_head_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_rows), build.ptr(thr), build.ptr(ptie), build.ptr(s_rows),
            build.ptr(x), build.ptr(starts), build.ptr(wends), nq, query_tile, c,
            build.ptr(fsum), build.ptr(cnt), build.stream_of(q_rows))
    build.check(rc, "band_head_kernel")
    band_head.launches += 1
    return fsum, cnt


def band_head(q_rows, thr, ptie, s_rows, x, starts, wends, *, query_tile: int,
              impl: str = "auto"):
    """(fsum [Nq_pad, C] float32, cnt [Nq_pad] float32): per-query sums of
    the listed feature rows and the count of listed non-zero rows.
    Arguments as in ``ops.band_conv.band_conv``."""
    if impl == "plain" or (impl == "auto" and not q_rows.is_cuda):
        return band_head_plain(q_rows, thr, ptie, s_rows, x, starts, wends,
                               query_tile=query_tile)
    return band_head_kernel(q_rows, thr, ptie, s_rows, x, starts, wends,
                            query_tile=query_tile)


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


def band_head_bwd_kernel(q_rows, thr, ptie, s_rows, g, starts, wends, *, query_tile: int):
    """Launch the K5 CUDA kernel (same contract as ``band_head_bwd_plain``)."""
    f32, i32 = torch.float32, torch.int32
    for t, dt, name in ((q_rows, f32, "q_rows"), (thr, f32, "thr"), (ptie, f32, "ptie"),
                        (s_rows, f32, "s_rows"), (g, f32, "g"), (starts, i32, "starts"),
                        (wends, i32, "wends")):
        build.require(t, dt, name)
    nq, c = g.shape
    ns = s_rows.shape[0]
    if (nq % query_tile or q_rows.shape[0] != nq or starts.shape[0] != nq // query_tile
            or c > C_MAX):
        raise ValueError("band_head_bwd: bad tile/shape arguments")
    first, end = covering_tiles(starts, wends, ns)
    dx = torch.empty((ns, c), dtype=f32, device=g.device)
    fn = build.load("head_bwd").band_head_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_rows), build.ptr(thr), build.ptr(ptie), build.ptr(s_rows),
            build.ptr(g), build.ptr(starts), build.ptr(wends), build.ptr(first),
            build.ptr(end), ns, query_tile, c, build.ptr(dx), build.stream_of(g))
    build.check(rc, "band_head_bwd_kernel")
    band_head_bwd.launches += 1
    return dx


def band_head_bwd(q_rows, thr, ptie, s_rows, g, starts, wends, *, query_tile: int,
                  impl: str = "auto"):
    """dx [Ns_pad, C] float32: the cotangent of ``band_head``'s sums
    ``g`` [Nq_pad, C] carried back to the support rows. ``impl`` as in
    ``band_head``."""
    if impl == "plain" or (impl == "auto" and not q_rows.is_cuda):
        return band_head_bwd_plain(q_rows, thr, ptie, s_rows, g, starts, wends,
                                   query_tile=query_tile)
    return band_head_bwd_kernel(q_rows, thr, ptie, s_rows, g, starts, wends,
                                query_tile=query_tile)


band_head_bwd.launches = 0


class BandHeadFn(torch.autograd.Function):
    """``band_head`` with K5 as its backward (port of
    ``d3feat_tpu/ops/pallas/head.py::band_head_ad``): differentiable in
    ``x``; the count is piecewise constant, its cotangent is dropped.

    ``apply(x, args, impl)`` with ``args`` the keyword arguments of
    ``band_head`` besides ``x`` (``models.kpfcnn.band_head_inputs``)."""

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
                           query_tile=a["query_tile"], impl=ctx.impl)
        return dx, None, None
