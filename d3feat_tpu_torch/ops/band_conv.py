"""K2 band KPConv (threshold selection) and its backward K4: kernel
wrappers, plain PyTorch twins, and the autograd function that joins them.

K2 ports ``d3feat_tpu/ops/pallas/band_conv.py::band_conv`` with
``thr``/``ptie``: for each sorted query of a tile, the support rows of the
tile's window that are in its neighbor list (recovered exactly from the
K1 thresholds), the linear-influence rigid KPConv over them, divided by the
count of selected rows with a positive feature sum (min 1). K4 ports
``_bwd_call`` (threshold mode): from the density-scaled cotangent
``gs = g / den``, ``dW[kp] = sum_q weighted_kp[q]^T gs[q]`` and
``dx[r] = sum over the queries q that list r of sum_kp w_kp(q, r)
(W[kp] gs[q])``; the kernel gathers ``G[r, kp] = sum_q w_kp(q, r) gs[q]``
over the transposed lists and multiplies ``dx = G W^T``.

The kernels (``ops/cuda/band_conv.cu``, ``ops/cuda/band_conv_bwd.cu``) work
from the per-query lists of the list stage (``ops/band_lists.py``), built
once per search and passed in as ``lists``; the forward keeps its weighted
rows ``[Nq_pad, KP * Cin]`` for the backward. ``band_conv_plain`` and
``band_conv_bwd_plain`` are their twins: they take the same arguments and
select from the windows themselves, as the TPU kernels do, ignoring
``lists``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.band_lists import uses_kernel
from d3feat_tpu_torch.ops.select import add_windows, exact_d2, tile_windows

_BIG = 1.0e10  # masked-out squared distance: w == 0 exactly
KP_MAX = 16  # kernel points: one m16 tile of the first product


def threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile: int):
    """[n_tiles, T, W] membership of each window row in each query's list,
    and the exact squared distances it was decided on."""
    n = rows.shape[0]
    q = q_rows.view(n, query_tile, 1, 4)
    s = rows[:, None]
    d2 = exact_d2(s, q)
    th = thr.view(n, query_tile, 1)
    pt = ptie.view(n, query_tile, 1)
    sel = inside[:, None] & (s[..., 3] == q[..., 3]) & (
        (d2 < th) | ((d2 == th) & (pos.float()[:, None] <= pt)))
    return sel, d2


def inv_extent_f32(extent: float) -> float:
    """``1 / extent`` rounded as the reference computes it (in float32)."""
    return float(np.float32(1.0) / np.float32(extent))


def kp_weights(d2m, rows, q, k, extent: float):
    """[n, T, W] linear influence of kernel point ``k`` [3] on every (query,
    window row) pair, from the masked exact d2 (``_BIG`` where not
    selected -> 0), by the reference's expansion and op order
    (``band_lists.cuh::kp_weight``)."""
    kx, ky, kz = k[0], k[1], k[2]
    a = -2.0 * ((rows[..., 0] * kx + rows[..., 1] * ky) + rows[..., 2] * kz)   # [n, W]
    b = (2.0 * ((q[..., 0] * kx + q[..., 1] * ky) + q[..., 2] * kz)
         + ((kx * kx + ky * ky) + kz * kz))                                      # [n, T]
    d2kp = torch.clamp((d2m + a[:, None, :]) + b[..., None], min=0.0)
    return torch.clamp(1.0 - torch.sqrt(d2kp) * inv_extent_f32(extent), min=0.0)


def band_conv_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                    *, query_tile: int, extent: float):
    """Twin of the K2 kernel (same contract), in plain PyTorch."""
    nq = q_rows.shape[0]
    n = nq // query_tile
    kpn, c, cout = weights.shape
    dev = q_rows.device
    if n == 0:
        return q_rows.new_zeros((0, cout)), q_rows.new_zeros((0,))
    rows, pos, inside = tile_windows(s_rows, starts, wends)        # [n, W, 4]
    sel, d2 = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)
    xw = x[pos] * inside[..., None]                                # [n, W, C]
    active = xw.sum(-1) > 0.0
    den = torch.clamp((sel & active[:, None]).sum(-1).float(), min=1.0)  # [n, T]
    d2m = torch.where(sel, d2, torch.tensor(_BIG, device=dev))
    q = q_rows.view(n, query_tile, 4)
    acc = torch.zeros((n, query_tile, cout), device=dev)
    for k in range(kpn):
        w = kp_weights(d2m, rows, q, kernel_points[k], extent)
        acc += torch.bmm(w, xw) @ weights[k]
    out = acc / den[..., None]
    return out.reshape(nq, cout), den.reshape(nq)


def _slices(m: int, n: int, k: int, ctas: int = 264):
    """(splits, kc) of a product's reduction over ``k``: enough CTAs of the
    product's tiles (64 x 64 outputs, 64 x 32 when ``n`` <= 32) to fill
    the card twice, at least 256 reduction steps a slice, ``kc`` a multiple
    of the 32-deep stage. Fixed by the shapes, so a product's sums always
    take the same order."""
    def cdiv(a, b):
        return -(-a // b)

    if k == 0:
        return 1, 32
    tiles = cdiv(m, 64) * cdiv(n, 32 if n <= 32 else 64)
    splits = max(1, min(cdiv(k, 256), cdiv(ctas, tiles)))
    kc = cdiv(cdiv(k, splits), 32) * 32
    return cdiv(k, kc), kc


def _depth_slices(k: int, depth: int = 512):
    """(splits, kc) cutting a reduction over ``k`` into slices of at most
    ``depth``: for K4's dx product, whose live row tiles (the support rows
    some list names) are not known from the shapes, so the tile count
    cannot size the slices."""
    splits = max(1, -(-k // depth))
    kc = max(32, -(-(-(-k // splits)) // 32) * 32)
    return max(1, -(-k // kc)), kc


def _check_shapes(q_rows, s_rows, x, weights, query_tile, starts):
    nq = q_rows.shape[0]
    kpn, c, cout = weights.shape
    if (nq % query_tile or starts.shape[0] != nq // query_tile or x.shape != (s_rows.shape[0], c)
            or kpn > KP_MAX or cout % 4):
        raise ValueError("band_conv: bad tile/shape arguments")


def _list_args(lists, q_rows):
    if lists is None:
        raise ValueError("band_conv kernels: no lists (ops.band_lists.band_lists of the search)")
    for t, dt, name in ((lists.lpos, torch.int32, "lpos"), (lists.ld2, torch.float32, "ld2"),
                        (lists.lcnt, torch.int32, "lcnt")):
        build.require(t, dt, name)
    if lists.lcnt.shape[0] != q_rows.shape[0]:
        raise ValueError("band_conv: lists of another search")
    return build.ptr(lists.lpos), build.ptr(lists.ld2), build.ptr(lists.lcnt)


_CONV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] + [
    ctypes.c_int] * 3 + [ctypes.c_void_p] * 6


def band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                     *, query_tile: int, extent: float, lists, keep_weighted=False):
    """Launch the K2 CUDA kernel (same contract as ``band_conv_plain``),
    from the search's ``lists``. With ``keep_weighted`` it also returns the
    weighted rows [Nq_pad, ldw] that K4 takes."""
    f32 = torch.float32
    for t, name in ((q_rows, "q_rows"), (s_rows, "s_rows"), (x, "x"), (weights, "weights"),
                    (kernel_points, "kernel_points")):
        build.require(t, f32, name)
    _check_shapes(q_rows, s_rows, x, weights, query_tile, starts)
    list_ptrs = _list_args(lists, q_rows)
    nq, ns = q_rows.shape[0], s_rows.shape[0]
    kpn, c, cout = weights.shape
    ldw = -(-kpn * c // 4) * 4
    splits, kc = _slices(nq, cout, kpn * c)
    dev = q_rows.device
    act = torch.empty((ns,), dtype=torch.int32, device=dev)
    wtd = torch.empty((nq, ldw), dtype=f32, device=dev)
    part = torch.empty((splits, nq, cout), dtype=f32, device=dev) if splits > 1 else None
    out = torch.empty((nq, cout), dtype=f32, device=dev)
    den = torch.empty((nq,), dtype=f32, device=dev)
    fn = build.launcher("band_conv", "band_conv_launch", _CONV_ARGS)
    rc = fn(build.ptr(q_rows), build.ptr(s_rows), build.ptr(x), build.ptr(weights),
            build.ptr(kernel_points), *list_ptrs, nq, ns, c, cout, kpn,
            inv_extent_f32(extent), ldw, splits, kc, build.ptr(act), build.ptr(wtd),
            None if part is None else build.ptr(part), build.ptr(out), build.ptr(den),
            build.stream_of(q_rows))
    build.check(rc, "band_conv_kernel")
    band_conv.launches += 1
    return (out, den, wtd) if keep_weighted else (out, den)


def band_conv(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
              *, query_tile: int, extent: float, impl: str = "auto", lists=None):
    """(out [Nq_pad, Cout] float32, den [Nq_pad] float32 clamped density).

    ``q_rows`` [Nq_pad, 4] sorted queries with their ``thr``/``ptie``
    [Nq_pad] (padding: cloud id -1), ``s_rows`` [Ns_pad, 4] and ``x``
    [Ns_pad, Cin] sorted supports and features (zero padding),
    ``weights`` [KP, Cin, Cout], ``kernel_points`` [KP, 3], windows
    ``starts``/``wends`` [n_tiles]; ``lists`` the search's
    ``ops.band_lists.BandLists`` (kernels only). ``impl`` as in
    ``ops.select.band_select``."""
    if not uses_kernel(impl, q_rows):
        return band_conv_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                               starts, wends, query_tile=query_tile, extent=extent)
    return band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                            starts, wends, query_tile=query_tile, extent=extent, lists=lists)


band_conv.launches = 0


def band_conv_bwd_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                        gs, *, query_tile: int, extent: float, need_dx: bool = True):
    """Twin of the K4 kernel (same contract), in plain PyTorch: the
    explicit products per kernel point, with each tile's window rows
    added into ``dx`` tile after tile."""
    nq = q_rows.shape[0]
    n = nq // query_tile
    kpn, c, cout = weights.shape
    dev = q_rows.device
    dw = torch.zeros((kpn, c, cout), device=dev)
    dx = torch.zeros((x.shape[0], c), device=dev) if need_dx else None
    if n == 0:
        return dx, dw
    rows, pos, inside = tile_windows(s_rows, starts, wends)        # [n, W, 4]
    sel, d2 = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)
    xw = x[pos] * inside[..., None]                                # [n, W, C]
    d2m = torch.where(sel, d2, torch.tensor(_BIG, device=dev))
    q = q_rows.view(n, query_tile, 4)
    gsv = gs.view(n, query_tile, cout)
    dxw = torch.zeros_like(xw) if need_dx else None
    for k in range(kpn):
        w = kp_weights(d2m, rows, q, kernel_points[k], extent)    # [n, T, W]
        weighted = torch.bmm(w, xw)                                # [n, T, C]
        dw[k] = weighted.reshape(-1, c).T @ gsv.reshape(-1, cout)
        if need_dx:
            dxw += torch.bmm(w.transpose(1, 2), gsv @ weights[k].T)
    if need_dx:
        dx = add_windows(dxw, pos, inside, x.shape[0])
    return dx, dw


_CONV_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] + [
    ctypes.c_int] * 5 + [ctypes.c_void_p] * 6


def band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                         gs, *, query_tile: int, extent: float, need_dx: bool = True,
                         lists, weighted):
    """Launch the K4 CUDA kernels (same contract as ``band_conv_bwd_plain``),
    from the search's ``lists`` and the forward's ``weighted`` rows
    (``band_conv_kernel(..., keep_weighted=True)``)."""
    f32 = torch.float32
    if weighted is None:
        raise ValueError("band_conv_bwd kernels: no weighted rows (kept by the forward)")
    for t, name in ((q_rows, "q_rows"), (s_rows, "s_rows"), (x, "x"), (weights, "weights"),
                    (kernel_points, "kernel_points"), (gs, "gs"), (weighted, "weighted")):
        build.require(t, f32, name)
    _check_shapes(q_rows, s_rows, x, weights, query_tile, starts)
    ld2_ptr = _list_args(lists, q_rows)[1]
    nq, ns = q_rows.shape[0], s_rows.shape[0]
    kpn, c, cout = weights.shape
    ldw = -(-kpn * c // 4) * 4
    if gs.shape != (nq, cout) or weighted.shape != (nq, ldw):
        raise ValueError("band_conv_bwd: bad cotangent or weighted-row shape")
    dev = q_rows.device
    splits, kc = _slices(kpn * c, cout, nq)
    dx_splits, dx_kc = _depth_slices(kpn * cout) if need_dx else (1, 32)
    n_part = max(splits * kpn * c * cout if splits > 1 else 0,
                 dx_splits * ns * c if dx_splits > 1 else 0)
    part = torch.empty((n_part,), dtype=f32, device=dev) if n_part else None
    dw = torch.empty((kpn, c, cout), dtype=f32, device=dev)
    if need_dx:
        row_ptr, pairs = lists.transpose(ns, impl="kernel")
        g_rows = torch.empty((ns, kpn * cout), dtype=f32, device=dev)
        dx = torch.empty((ns, c), dtype=f32, device=dev)
        dx_ptrs = (build.ptr(row_ptr), build.ptr(pairs))
        out_ptrs = (build.ptr(g_rows), build.ptr(dx))
    else:
        dx = None
        dx_ptrs = out_ptrs = (None, None)
    fn = build.launcher("band_conv_bwd", "band_conv_bwd_launch", _CONV_BWD_ARGS)
    rc = fn(build.ptr(q_rows), build.ptr(s_rows), build.ptr(weights), build.ptr(kernel_points),
            build.ptr(gs), ld2_ptr, *dx_ptrs, nq, ns, c, cout, kpn, inv_extent_f32(extent), ldw,
            splits, kc, dx_splits, dx_kc, build.ptr(weighted),
            None if part is None else build.ptr(part),
            build.ptr(dw), *out_ptrs, build.stream_of(q_rows))
    build.check(rc, "band_conv_bwd_kernel")
    band_conv_bwd.launches += 1
    return dx, dw


def band_conv_bwd(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends, gs,
                  *, query_tile: int, extent: float, need_dx: bool = True,
                  impl: str = "auto", lists=None, weighted=None):
    """(dx [Ns_pad, Cin] or None, dW [KP, Cin, Cout]) float32 from the
    density-scaled cotangent ``gs`` [Nq_pad, Cout]; other arguments as in
    ``band_conv``, plus the forward's ``weighted`` rows (kernels only).
    ``need_dx=False`` skips dx."""
    if not uses_kernel(impl, q_rows):
        return band_conv_bwd_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                   starts, wends, gs, query_tile=query_tile, extent=extent,
                                   need_dx=need_dx)
    return band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                starts, wends, gs, query_tile=query_tile, extent=extent,
                                need_dx=need_dx, lists=lists, weighted=weighted)


band_conv_bwd.launches = 0


class BandConvFn(torch.autograd.Function):
    """``band_conv`` with K4 as its backward (port of
    ``d3feat_tpu/ops/pallas/band_conv.py::band_conv_ad`` in threshold
    mode): differentiable in ``x`` and ``weights``. The density is a count
    (constant), the kernel points are buffers (no gradient).

    ``apply(x, weights, kernel_points, args, impl)`` with ``args`` the
    keyword arguments of ``band_conv`` besides those three
    (``models.blocks.band_conv_inputs``, with the search's ``lists`` on the
    kernel path); returns ``out`` [Nq_pad, Cout]. On the kernel path the
    backward reuses the forward's lists and weighted rows."""

    @staticmethod
    def forward(ctx, x, weights, kernel_points, args, impl):
        wtd = None
        if uses_kernel(impl, x):
            out, den, wtd = band_conv_kernel(x=x, weights=weights, kernel_points=kernel_points,
                                             keep_weighted=True, **args)
        else:
            out, den = band_conv(x=x, weights=weights, kernel_points=kernel_points,
                                 impl=impl, **args)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            saved = (x, weights, kernel_points, den) + ((wtd,) if wtd is not None else ())
            ctx.save_for_backward(*saved)
        ctx.args, ctx.impl = args, impl
        return out

    @staticmethod
    def backward(ctx, g):
        x, weights, kernel_points, den, *wtd = ctx.saved_tensors
        gs = (g.float() / den[:, None]).contiguous()
        kw = dict(weighted=wtd[0]) if wtd else {}
        dx, dw = band_conv_bwd(x=x, weights=weights, kernel_points=kernel_points, gs=gs,
                               need_dx=ctx.needs_input_grad[0], impl=ctx.impl, **ctx.args, **kw)
        return dx, dw, None, None, None
