"""K2 band KPConv (threshold selection, forward): kernel wrapper and plain
PyTorch twin.

Port of ``d3feat_tpu/ops/pallas/band_conv.py::band_conv`` with
``thr``/``ptie``: for each sorted query of a tile, the support rows of the
tile's window that are in its neighbor list (recovered exactly from the
K1 thresholds), the linear-influence rigid KPConv over them, divided by the
count of selected rows with a positive feature sum (min 1).

The kernel is ``ops/cuda/band_conv.cu``; ``band_conv_plain`` is its twin.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.select import exact_d2, tile_windows

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
    inv_extent = inv_extent_f32(extent)
    q = q_rows.view(n, query_tile, 4)
    acc = torch.zeros((n, query_tile, cout), device=dev)
    for k in range(kpn):
        kx, ky, kz = kernel_points[k, 0], kernel_points[k, 1], kernel_points[k, 2]
        a = -2.0 * ((rows[..., 0] * kx + rows[..., 1] * ky) + rows[..., 2] * kz)   # [n, W]
        b = (2.0 * ((q[..., 0] * kx + q[..., 1] * ky) + q[..., 2] * kz)
             + ((kx * kx + ky * ky) + kz * kz))                                      # [n, T]
        d2kp = torch.clamp((d2m + a[:, None, :]) + b[..., None], min=0.0)
        w = torch.clamp(1.0 - torch.sqrt(d2kp) * inv_extent, min=0.0)              # [n, T, W]
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
