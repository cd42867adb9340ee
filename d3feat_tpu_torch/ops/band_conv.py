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
(W[kp] gs[q])``.

The kernels are ``ops/cuda/band_conv.cu`` and ``ops/cuda/band_conv_bwd.cu``;
``band_conv_plain`` and ``band_conv_bwd_plain`` are their twins.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.select import add_windows, covering_tiles, exact_d2, tile_windows

_BIG = 1.0e10  # masked-out squared distance: w == 0 exactly
CIN_MAX = 1536  # shared-memory bound of the kernel's [32, Cin] panel


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


def band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                     *, query_tile: int, extent: float):
    """Launch the K2 CUDA kernel (same contract as ``band_conv_plain``)."""
    f32, i32 = torch.float32, torch.int32
    for t, dt, name in ((q_rows, f32, "q_rows"), (thr, f32, "thr"), (ptie, f32, "ptie"),
                        (s_rows, f32, "s_rows"), (x, f32, "x"), (weights, f32, "weights"),
                        (kernel_points, f32, "kernel_points"), (starts, i32, "starts"),
                        (wends, i32, "wends")):
        build.require(t, dt, name)
    nq = q_rows.shape[0]
    kpn, c, cout = weights.shape
    if (nq % query_tile or query_tile % 32 or starts.shape[0] != nq // query_tile
            or x.shape[1] != c or x.shape[0] != s_rows.shape[0] or c > CIN_MAX):
        raise ValueError("band_conv: bad tile/shape arguments")
    out = torch.empty((nq, cout), dtype=f32, device=q_rows.device)
    den = torch.empty((nq,), dtype=f32, device=q_rows.device)
    fn = build.load("band_conv").band_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_rows), build.ptr(thr), build.ptr(ptie), build.ptr(s_rows),
            build.ptr(x), build.ptr(weights), build.ptr(kernel_points), build.ptr(starts),
            build.ptr(wends), nq, query_tile, c, cout, kpn, inv_extent_f32(extent),
            build.ptr(out), build.ptr(den), build.stream_of(q_rows))
    build.check(rc, "band_conv_kernel")
    band_conv.launches += 1
    return out, den


def band_conv(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
              *, query_tile: int, extent: float, impl: str = "auto"):
    """(out [Nq_pad, Cout] float32, den [Nq_pad] float32 clamped density).

    ``q_rows`` [Nq_pad, 4] sorted queries with their ``thr``/``ptie``
    [Nq_pad] (padding: cloud id -1), ``s_rows`` [Ns_pad, 4] and ``x``
    [Ns_pad, Cin] sorted supports and features (zero padding),
    ``weights`` [KP, Cin, Cout], ``kernel_points`` [KP, 3], windows
    ``starts``/``wends`` [n_tiles]. ``impl`` as in ``ops.select.band_select``."""
    if impl == "plain" or (impl == "auto" and not q_rows.is_cuda):
        return band_conv_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                               starts, wends, query_tile=query_tile, extent=extent)
    return band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                            starts, wends, query_tile=query_tile, extent=extent)


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


def _dw_split(m: int, n: int, k: int, tile: int = 64, chunk: int = 16, ctas: int = 264):
    """(splits, queries per split) of the dW product's reduction over the
    ``k`` queries: enough CTAs of ``tile`` x ``tile`` outputs to fill the
    card twice, at least 256 queries a split, a multiple of ``chunk``."""
    def cdiv(a, b):
        return -(-a // b)

    if k == 0:
        return 1, chunk
    splits = max(1, min(cdiv(k, 256), cdiv(ctas, cdiv(m, tile) * cdiv(n, tile))))
    kc = cdiv(cdiv(k, splits), chunk) * chunk
    return cdiv(k, kc), kc


DX_CMAX = 512  # channels of a support row held in one warp's registers by K4's dx pass


def band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                         gs, *, query_tile: int, extent: float, need_dx: bool = True):
    """Launch the K4 CUDA kernels (same contract as ``band_conv_bwd_plain``)."""
    f32, i32 = torch.float32, torch.int32
    for t, dt, name in ((q_rows, f32, "q_rows"), (thr, f32, "thr"), (ptie, f32, "ptie"),
                        (s_rows, f32, "s_rows"), (x, f32, "x"), (weights, f32, "weights"),
                        (kernel_points, f32, "kernel_points"), (starts, i32, "starts"),
                        (wends, i32, "wends"), (gs, f32, "gs")):
        build.require(t, dt, name)
    nq = q_rows.shape[0]
    ns = s_rows.shape[0]
    kpn, c, cout = weights.shape
    if (nq % query_tile or query_tile % 32 or starts.shape[0] != nq // query_tile
            or x.shape != (ns, c) or gs.shape != (nq, cout) or kpn > 32
            or (need_dx and c > DX_CMAX)):
        raise ValueError("band_conv_bwd: bad tile/shape arguments")
    dev = q_rows.device
    splits, kc = _dw_split(kpn * c, cout, nq)
    wtd = torch.empty((nq, kpn * c), dtype=f32, device=dev)
    part = torch.empty((splits, kpn * c, cout), dtype=f32, device=dev) if splits > 1 else None
    dw = torch.empty((kpn, c, cout), dtype=f32, device=dev)
    if need_dx:
        first, end = covering_tiles(starts, wends, ns)
        gw = torch.empty((nq, kpn * c), dtype=f32, device=dev)
        dx = torch.empty((ns, c), dtype=f32, device=dev)
        dx_ptrs = (build.ptr(first), build.ptr(end), build.ptr(gw), build.ptr(dx))
    else:
        dx = None
        dx_ptrs = (None,) * 4
    fn = build.load("band_conv_bwd").band_conv_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_rows), build.ptr(thr), build.ptr(ptie), build.ptr(s_rows),
            build.ptr(x), build.ptr(weights), build.ptr(kernel_points), build.ptr(gs),
            build.ptr(starts), build.ptr(wends), nq, ns, query_tile, c, cout, kpn,
            inv_extent_f32(extent), splits, kc, build.ptr(wtd),
            None if part is None else build.ptr(part), build.ptr(dw), *dx_ptrs,
            build.stream_of(q_rows))
    build.check(rc, "band_conv_bwd_kernel")
    band_conv_bwd.launches += 1
    return dx, dw


def band_conv_bwd(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends, gs,
                  *, query_tile: int, extent: float, need_dx: bool = True,
                  impl: str = "auto"):
    """(dx [Ns_pad, Cin] or None, dW [KP, Cin, Cout]) float32 from the
    density-scaled cotangent ``gs`` [Nq_pad, Cout]; other arguments as in
    ``band_conv``. ``need_dx=False`` skips dx."""
    if impl == "plain" or (impl == "auto" and not q_rows.is_cuda):
        return band_conv_bwd_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                   starts, wends, gs, query_tile=query_tile, extent=extent,
                                   need_dx=need_dx)
    return band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                starts, wends, gs, query_tile=query_tile, extent=extent,
                                need_dx=need_dx)


band_conv_bwd.launches = 0


class BandConvFn(torch.autograd.Function):
    """``band_conv`` with K4 as its backward (port of
    ``d3feat_tpu/ops/pallas/band_conv.py::band_conv_ad`` in threshold
    mode): differentiable in ``x`` and ``weights``. The density is a count
    (constant), the kernel points are buffers (no gradient).

    ``apply(x, weights, kernel_points, args, impl)`` with ``args`` the
    keyword arguments of ``band_conv`` besides those three
    (``models.blocks.band_conv_inputs``); returns ``out`` [Nq_pad, Cout]."""

    @staticmethod
    def forward(ctx, x, weights, kernel_points, args, impl):
        out, den = band_conv(x=x, weights=weights, kernel_points=kernel_points, impl=impl,
                             **args)
        ctx.save_for_backward(x, weights, kernel_points, den)
        ctx.args, ctx.impl = args, impl
        return out

    @staticmethod
    def backward(ctx, g):
        x, weights, kernel_points, den = ctx.saved_tensors
        gs = (g.float() / den[:, None]).contiguous()
        dx, dw = band_conv_bwd(x=x, weights=weights, kernel_points=kernel_points, gs=gs,
                               need_dx=ctx.needs_input_grad[0], impl=ctx.impl, **ctx.args)
        return dx, dw, None, None, None
