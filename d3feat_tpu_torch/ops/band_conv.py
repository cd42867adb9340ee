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

List mode (``thr=None``, ``neighb=`` the search's position lists [K,
Nq_pad]; the TPU kernels' ``use_thr=False``): a window row is selected
as often as the query lists its position, and weighed from the
coordinates alone, ``w = max(1 - sqrt(|s - (q + k)|^2) / extent, 0)``
(``list_weights``), not by the threshold mode's expansion; the density
counts the selections. The kernels take the list-mode lists of
``ops.band_lists.band_lists_given`` (``lists.mode == "list"``).

``panel_dtype="bfloat16"`` (``compute_dtype="bfloat16"`` of the model)
runs the products on bf16 operands with f32 accumulation, as the TPU
kernels' bf16 panels do; geometry, selection, thresholds and the density
count stay f32. The kernels and their twins round to bf16 where the TPU
kernels round (``band_conv.py:230-239, 493-523``): x, W and gs; each
influence weight w_kp; ``weighted`` once for each chunk of ``chunk`` rows
of the tile's window (the TPU kernel's chunks, ``ops.neighbors.pick_chunk``
of the band cap), the rounded pieces added in f32; in K4, ``gs W[kp]^T``
before it multiplies w_kp. The density flag reads the rounded x, as the TPU
kernel sums its bf16 panel. The kernels keep the sum of a query's rounded
pieces as two bf16 rows, ``hi = bf16(S)`` and ``lo = bf16(S - hi)``
(``hi + lo = S`` to about 2**-17 relative), and multiply both by W, so
every product stays one of bf16 operands; the twins do the same. K2's
bf16 panel of W is kept for K4, beside the weighted rows. K4's bf16 dx
goes by pairs: ``U = sum_kp bf16(w_kp(q, r)) V[q, kp]`` for each listed
(query, row) pair, ``V = bf16(gs W^T)``, then each support row's sum of
its pairs' U in ascending pair order. A
product of two bf16 values is exact in f32, so the twins emulate the
tensor cores' bf16 products as ``t.to(bfloat16).float()`` followed by f32
products.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from d3feat_tpu_torch.ops import build
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


def list_select(pos, inside, neighb, query_tile: int):
    """[n_tiles, T, W] float: how often each query lists each window row
    (list mode: the TPU kernel sums ``position == neighb[k]`` over k)."""
    n, width = pos.shape
    k = neighb.shape[0]
    p = neighb.T.reshape(n, query_tile * k).long()                   # [n, T * K]
    off = p - pos[:, :1]                                             # window offsets
    ok = (off >= 0) & (off < width)
    off = torch.where(ok, off, 0)
    ok = ok & torch.gather(inside, 1, off)
    sel = torch.zeros((n, query_tile * width), device=pos.device)
    flat = (torch.arange(query_tile * k, device=pos.device) // k) * width
    sel.scatter_add_(1, flat[None, :] + off, ok.float())
    return sel.view(n, query_tile, width)


def list_weights(s, q, k, extent: float):
    """List mode's influence of kernel point ``k`` [3] on the pairs of
    broadcastable support rows ``s`` and query rows ``q`` [..., 4], in the
    TPU kernel's op order (``band_lists.cuh::kp_weight_list``): per axis
    ``d = s - (q + k)``, ``d2 = (dx dx + dy dy) + dz dz``, then ``max(1 -
    sqrt(d2) / extent, 0)``, a true division."""
    dx = s[..., 0] - (q[..., 0] + k[0])
    dy = s[..., 1] - (q[..., 1] + k[1])
    dz = s[..., 2] - (q[..., 2] + k[2])
    d2 = (dx * dx + dy * dy) + dz * dz
    ext = torch.tensor(extent, dtype=torch.float32, device=d2.device)
    return torch.clamp(1.0 - torch.sqrt(d2) / ext, min=0.0)


def window_selection(rows, pos, inside, q_rows, thr, ptie, neighb, query_tile: int, extent):
    """(sel [n, T, W] float, how often each query selects each window row,
    and ``weight(k)``: [n, T, W] influence of kernel point ``k`` times the
    selection) of threshold mode (``thr``/``ptie``) or list mode
    (``thr=None``, ``neighb``)."""
    n = rows.shape[0]
    q = q_rows.view(n, query_tile, 4)
    if thr is None:
        if neighb is None:
            raise ValueError("band_conv: list mode (thr=None) needs the position lists (neighb=)")
        sel = list_select(pos, inside, neighb, query_tile)
        return sel, lambda k: list_weights(rows[:, None], q[:, :, None], k, extent) * sel
    selb, d2 = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)
    d2m = torch.where(selb, d2, torch.tensor(_BIG, device=rows.device))
    return selb.float(), lambda k: kp_weights(d2m, rows, q, k, extent)


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


PANEL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def panel_rounding(panel_dtype: str):
    """The rounding of a product operand to the panel dtype, back in f32
    (the identity for f32 panels)."""
    if panel_dtype not in PANEL_DTYPES:
        raise ValueError(f"panel_dtype: {panel_dtype!r}")
    if panel_dtype == "float32":
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).float()


def _chunk_of(panel_dtype: str, chunk):
    """The window's chunk rows that the bf16 panels round ``weighted`` at
    (ignored by the f32 panels)."""
    if panel_dtype == "bfloat16" and (chunk is None or chunk < 1):
        raise ValueError("band_conv: bf16 panels need the window's chunk (chunk=)")
    return chunk


def weighted_hi_lo(w, xw, chunk: int):
    """bf16 first product of each query over its window [n, T, W] x [n, W,
    C]: the window cut into chunks of ``chunk`` rows, each chunk's product
    rounded to bf16, the pieces added in f32 in chunk order (``S``); returns
    ``hi = bf16(S)`` and ``lo = bf16(S - hi)``, as f32."""
    rnd = panel_rounding("bfloat16")
    s = torch.zeros((w.shape[0], w.shape[1], xw.shape[2]), device=w.device)
    for a in range(0, w.shape[2], chunk):
        s = s + rnd(torch.bmm(w[..., a:a + chunk], xw[:, a:a + chunk]))
    hi = rnd(s)
    return hi, rnd(s - hi)


def band_conv_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                    *, query_tile: int, extent: float, panel_dtype: str = "float32",
                    chunk=None, neighb=None):
    """Twin of the K2 kernel (same contract), in plain PyTorch."""
    rnd = panel_rounding(panel_dtype)
    chunk = _chunk_of(panel_dtype, chunk)
    nq = q_rows.shape[0]
    n = nq // query_tile
    kpn, c, cout = weights.shape
    dev = q_rows.device
    if n == 0:
        return q_rows.new_zeros((0, cout)), q_rows.new_zeros((0,))
    rows, pos, inside = tile_windows(s_rows, starts, wends)        # [n, W, 4]
    sel, weight = window_selection(rows, pos, inside, q_rows, thr, ptie, neighb, query_tile,
                                   extent)
    xw = rnd(x[pos] * inside[..., None])                           # [n, W, C]
    active = xw.sum(-1) > 0.0
    den = torch.clamp((sel * active[:, None]).sum(-1), min=1.0)    # [n, T]
    wr = rnd(weights)
    acc = torch.zeros((n, query_tile, cout), device=dev)
    acc_lo = torch.zeros_like(acc)  # bf16: the products of the lo rows
    for k in range(kpn):
        w = rnd(weight(kernel_points[k]))
        if panel_dtype == "float32":
            acc += torch.bmm(w, xw) @ wr[k]
        else:
            hi, lo = weighted_hi_lo(w, xw, chunk)
            acc += hi @ wr[k]
            acc_lo += lo @ wr[k]
    out = (acc + acc_lo) / den[..., None]
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


def _check_shapes(q_rows, s_rows, x, weights, query_tile, starts, panel_dtype):
    """Raises on shapes the kernels do not take; returns the row length of
    the weighted rows (``KP * Cin`` rounded up to 16 bytes of the panel
    dtype: rows are read in 16-byte chunks, as are the Cout-wide rows, and
    with bf16 panels the Cin-wide rows from 8 channels on)."""
    nq = q_rows.shape[0]
    kpn, c, cout = weights.shape
    vec = 16 // PANEL_DTYPES[panel_dtype].itemsize
    if (nq % query_tile or starts.shape[0] != nq // query_tile or x.shape != (s_rows.shape[0], c)
            or kpn > KP_MAX or cout % vec or (vec == 8 and c >= 8 and c % vec)):
        raise ValueError("band_conv: bad tile/shape arguments")
    return -(-kpn * c // vec) * vec


def _list_args(lists, q_rows, thr):
    """The lists' pointers (``ld2`` None in list mode); raises unless the
    lists' mode is the call's (``thr`` None: list mode)."""
    if lists is None:
        raise ValueError("band_conv kernels: no lists (ops.band_lists.band_lists of the search)")
    if (lists.mode == "list") != (thr is None):
        raise ValueError(f"band_conv kernels: {lists.mode}-mode lists for a "
                         f"{'list' if thr is None else 'threshold'}-mode call")
    for t, dt, name in ((lists.lpos, torch.int32, "lpos"), (lists.lcnt, torch.int32, "lcnt"),
                        *(((lists.ld2, torch.float32, "ld2"),) if lists.ld2 is not None else ())):
        build.require(t, dt, name)
    if lists.lcnt.shape[0] != q_rows.shape[0]:
        raise ValueError("band_conv: lists of another search")
    ld2 = None if lists.ld2 is None else build.ptr(lists.ld2)
    return build.ptr(lists.lpos), ld2, build.ptr(lists.lcnt)


def _count(wrapper, lists, bf16: bool) -> None:
    """One launch more in the wrapper's count of the lists' mode and panel
    dtype: ``launches`` (threshold mode, f32 panels), ``launches_bf16``,
    ``launches_list`` and ``launches_list_bf16``."""
    name = "launches" + ("_list" if lists.mode == "list" else "") + ("_bf16" if bf16 else "")
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _influence(extent: float, lists):
    """The kernels' influence arguments: 1 / extent (threshold mode), the
    extent (list mode) and the mode flag."""
    return inv_extent_f32(extent), float(np.float32(extent)), int(lists.mode == "list")


_CONV_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
# + starts, tile, chunk and the bf16 panels of x and W
_CONV_BF16_ARGS = _CONV_ARGS[:-1] + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [
    ctypes.c_void_p] * 3


def band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                     *, query_tile: int, extent: float, lists, keep_weighted=False,
                     panel_dtype: str = "float32", chunk=None, neighb=None):
    """Launch the K2 CUDA kernel (same contract as ``band_conv_plain``),
    from the search's ``lists`` (of the call's mode; ``neighb`` is not
    read): the f32 kernel, or with
    ``panel_dtype="bfloat16"`` the bf16 one. With ``keep_weighted`` it also
    returns what K4 takes: the weighted rows, [Nq_pad, ldw] f32, or in bf16
    [2 * Nq_pad, ldw], the hi rows then the lo rows, and the bf16 panel of
    ``weights`` (None for f32 panels)."""
    f32 = torch.float32
    for t, name in ((q_rows, "q_rows"), (s_rows, "s_rows"), (x, "x"), (weights, "weights"),
                    (kernel_points, "kernel_points")):
        build.require(t, f32, name)
    ldw = _check_shapes(q_rows, s_rows, x, weights, query_tile, starts, panel_dtype)
    chunk = _chunk_of(panel_dtype, chunk)
    list_ptrs = _list_args(lists, q_rows, thr)
    nq, ns = q_rows.shape[0], s_rows.shape[0]
    kpn, c, cout = weights.shape
    bf16 = panel_dtype == "bfloat16"
    rows = 2 * nq if bf16 else nq  # bf16: the hi and the lo rows
    splits, kc = _slices(rows, cout, kpn * c)
    dev = q_rows.device
    act = torch.empty((ns,), dtype=torch.int32, device=dev)
    wtd = torch.empty((rows, ldw), dtype=PANEL_DTYPES[panel_dtype], device=dev)
    # bf16: the slices' partial sums of the hi and of the lo rows
    part = torch.empty((splits, rows, cout), dtype=f32, device=dev) if splits > 1 else None
    out = torch.empty((nq, cout), dtype=f32, device=dev)
    den = torch.empty((nq,), dtype=f32, device=dev)
    args = [build.ptr(q_rows), build.ptr(s_rows), build.ptr(x), build.ptr(weights),
            build.ptr(kernel_points), *list_ptrs, nq, ns, c, cout, kpn, lists.width,
            *_influence(extent, lists), ldw, splits, kc, build.ptr(act), build.ptr(wtd),
            None if part is None else build.ptr(part), build.ptr(out), build.ptr(den)]
    wb = None
    if bf16:  # the bf16 panels of x and W, written by the launcher
        build.require(starts, torch.int32, "starts")
        xb = torch.empty((ns, c), dtype=torch.bfloat16, device=dev)
        wb = torch.empty((kpn, c, cout), dtype=torch.bfloat16, device=dev)
        fn = build.launcher("band_conv", "band_conv_bf16_launch", _CONV_BF16_ARGS)
        build.check(fn(*args, build.ptr(starts), query_tile, chunk, build.ptr(xb),
                       build.ptr(wb), build.stream_of(q_rows)), "band_conv_kernel (bf16)")
    else:
        fn = build.launcher("band_conv", "band_conv_launch", _CONV_ARGS)
        build.check(fn(*args, build.stream_of(q_rows)), "band_conv_kernel")
    _count(band_conv, lists, bf16)
    return (out, den, wtd, wb) if keep_weighted else (out, den)


def band_conv(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
              *, query_tile: int, extent: float, impl: str = "auto", lists=None,
              panel_dtype: str = "float32", chunk=None, neighb=None):
    """(out [Nq_pad, Cout] float32, den [Nq_pad] float32 clamped density).

    ``q_rows`` [Nq_pad, 4] sorted queries with their ``thr``/``ptie``
    [Nq_pad] (padding: cloud id -1), ``s_rows`` [Ns_pad, 4] and ``x``
    [Ns_pad, Cin] sorted supports and features (zero padding),
    ``weights`` [KP, Cin, Cout], ``kernel_points`` [KP, 3], windows
    ``starts``/``wends`` [n_tiles]; list mode: ``thr``/``ptie`` None and
    ``neighb`` [K, Nq_pad] int32 the search's position lists (padded
    queries list the shadow); ``lists`` the search's
    ``ops.band_lists.BandLists`` of the same mode (kernels only); ``panel_dtype``
    "float32" or "bfloat16" (module docstring), with bf16 the window's
    ``chunk`` rows. ``impl`` as in ``ops.select.band_select``. Launches of
    the f32 kernel count in ``band_conv.launches``, of the bf16 one in
    ``band_conv.launches_bf16``, in list mode in ``launches_list`` and
    ``launches_list_bf16``."""
    kw = dict(query_tile=query_tile, extent=extent, panel_dtype=panel_dtype, chunk=chunk)
    if not build.uses_kernel(impl, q_rows):
        return band_conv_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                               starts, wends, neighb=neighb, **kw)
    return band_conv_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                            starts, wends, lists=lists, **kw)


band_conv.launches = band_conv.launches_bf16 = 0
band_conv.launches_list = band_conv.launches_list_bf16 = 0


def band_conv_bwd_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                        gs, *, query_tile: int, extent: float, need_dx: bool = True,
                        panel_dtype: str = "float32", chunk=None, neighb=None):
    """Twin of the K4 kernel (same contract), in plain PyTorch: the
    explicit products per kernel point, with each tile's window rows
    added into ``dx`` tile after tile. With bf16 panels, dW from the hi and
    lo rows of the rounded pieces and dx from ``bf16(gs W[kp]^T)``, as the
    kernel computes them."""
    bf16 = panel_dtype == "bfloat16"
    rnd = panel_rounding(panel_dtype)
    chunk = _chunk_of(panel_dtype, chunk)
    nq = q_rows.shape[0]
    n = nq // query_tile
    kpn, c, cout = weights.shape
    dev = q_rows.device
    dw = torch.zeros((kpn, c, cout), device=dev)
    dx = torch.zeros((x.shape[0], c), device=dev) if need_dx else None
    if n == 0:
        return dx, dw
    rows, pos, inside = tile_windows(s_rows, starts, wends)        # [n, W, 4]
    _, weight = window_selection(rows, pos, inside, q_rows, thr, ptie, neighb, query_tile,
                                 extent)
    xw = rnd(x[pos] * inside[..., None])                           # [n, W, C]
    gsv = rnd(gs).view(n, query_tile, cout)
    wr = rnd(weights)
    g2 = gsv.reshape(-1, cout)
    dxw = torch.zeros_like(xw) if need_dx else None
    for k in range(kpn):
        w = rnd(weight(kernel_points[k]))                          # [n, T, W]
        if bf16:
            hi, lo = weighted_hi_lo(w, xw, chunk)                  # [n, T, C]
            dw[k] = hi.reshape(-1, c).T @ g2 + lo.reshape(-1, c).T @ g2
        else:
            dw[k] = torch.bmm(w, xw).reshape(-1, c).T @ g2
        if need_dx:
            dxw += torch.bmm(w.transpose(1, 2), rnd(gsv @ wr[k].T))
    if need_dx:
        dx = add_windows(dxw, pos, inside, x.shape[0])
    return dx, dw


_CONV_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
_CONV_BWD_BF16_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [
    ctypes.c_int] * 4 + [ctypes.c_void_p] * 8


def band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends,
                         gs, *, query_tile: int, extent: float, need_dx: bool = True,
                         lists, weighted, weights_panel=None, panel_dtype: str = "float32",
                         chunk=None, neighb=None):
    """Launch the K4 CUDA kernels (same contract as ``band_conv_bwd_plain``),
    from the search's ``lists`` and what the forward kept
    (``band_conv_kernel(..., keep_weighted=True)``, of the same
    ``panel_dtype``): the ``weighted`` rows (bf16: K2's hi and lo rows, of
    its ``chunk``) and, for bf16 with dx, K2's bf16 panel of ``weights``
    (``weights_panel``)."""
    f32, bf = torch.float32, torch.bfloat16
    if weighted is None:
        raise ValueError("band_conv_bwd kernels: no weighted rows (kept by the forward)")
    for t, dt, name in ((q_rows, f32, "q_rows"), (s_rows, f32, "s_rows"), (x, f32, "x"),
                        (weights, f32, "weights"), (kernel_points, f32, "kernel_points"),
                        (gs, f32, "gs"), (weighted, PANEL_DTYPES[panel_dtype], "weighted")):
        build.require(t, dt, name)
    ldw = _check_shapes(q_rows, s_rows, x, weights, query_tile, starts, panel_dtype)
    list_ptrs = _list_args(lists, q_rows, thr)
    nq, ns = q_rows.shape[0], s_rows.shape[0]
    kpn, c, cout = weights.shape
    bf16 = panel_dtype == "bfloat16"
    _chunk_of(panel_dtype, chunk)
    rows = 2 * nq if bf16 else nq  # bf16: the hi and the lo rows
    if gs.shape != (nq, cout) or weighted.shape != (rows, ldw):
        raise ValueError("band_conv_bwd: bad cotangent or weighted-row shape")
    if bf16 and need_dx:
        if weights_panel is None:
            raise ValueError("band_conv_bwd kernels: bf16 dx needs K2's bf16 weights panel")
        build.require(weights_panel, bf, "weights_panel")
        if weights_panel.shape != weights.shape or c % 8:
            raise ValueError("band_conv_bwd: bad weights panel, or bf16 dx of Cin % 8 != 0")
    dev = q_rows.device
    splits, kc = _slices(kpn * c, cout, nq)
    dx_splits, dx_kc = _depth_slices(kpn * cout) if need_dx and not bf16 else (1, 32)
    # bf16: the slices' partial sums of dW over the hi and over the lo rows
    n_part = max(splits * kpn * c * cout * (2 if bf16 else 1) if splits > 1 else 0,
                 dx_splits * ns * c if dx_splits > 1 else 0)
    part = torch.empty((n_part,), dtype=f32, device=dev) if n_part else None
    dw = torch.empty((kpn, c, cout), dtype=f32, device=dev)
    dx = torch.empty((ns, c), dtype=f32, device=dev) if need_dx else None
    row_ptr, pairs = lists.transpose(ns, impl="kernel") if need_dx else (None, None)
    opt = lambda t: None if t is None else build.ptr(t)  # noqa: E731
    geo = (build.ptr(q_rows), build.ptr(s_rows))
    shape = (nq, ns, c, cout, kpn, lists.width, *_influence(extent, lists), ldw, splits, kc)
    if bf16:
        # V = bf16(gs W^T) [Nq, KP * Cin] and U [Nq * L, Cin] for dx, gs's bf16 panel
        v = torch.empty((nq, kpn * c), dtype=bf, device=dev) if need_dx else None
        u = torch.empty((nq * lists.width, c), dtype=f32, device=dev) if need_dx else None
        gsb = torch.empty((nq, cout), dtype=bf, device=dev)
        fn = build.launcher("band_conv_bwd", "band_conv_bwd_bf16_launch", _CONV_BWD_BF16_ARGS)
        build.check(fn(*geo, opt(weights_panel if need_dx else None), build.ptr(kernel_points),
                       build.ptr(gs), *list_ptrs, opt(row_ptr), opt(pairs), *shape,
                       build.ptr(weighted), opt(part), build.ptr(dw), opt(v), opt(u), opt(dx),
                       build.ptr(gsb), build.stream_of(q_rows)), "band_conv_bwd_kernel (bf16)")
    else:
        g_rows = torch.empty((ns, kpn * cout), dtype=f32, device=dev) if need_dx else None
        fn = build.launcher("band_conv_bwd", "band_conv_bwd_launch", _CONV_BWD_ARGS)
        build.check(fn(*geo, build.ptr(weights), build.ptr(kernel_points), build.ptr(gs),
                       list_ptrs[1], opt(row_ptr), opt(pairs), *shape, dx_splits, dx_kc,
                       build.ptr(weighted), opt(part), build.ptr(dw), opt(g_rows), opt(dx),
                       build.stream_of(q_rows)), "band_conv_bwd_kernel")
    _count(band_conv_bwd, lists, bf16)
    return dx, dw


def band_conv_bwd(q_rows, thr, ptie, s_rows, x, weights, kernel_points, starts, wends, gs,
                  *, query_tile: int, extent: float, need_dx: bool = True,
                  impl: str = "auto", lists=None, weighted=None, weights_panel=None,
                  panel_dtype: str = "float32", chunk=None, neighb=None):
    """(dx [Ns_pad, Cin] or None, dW [KP, Cin, Cout]) float32 from the
    density-scaled cotangent ``gs`` [Nq_pad, Cout]; other arguments as in
    ``band_conv``, plus what the forward kept, its ``weighted`` rows and
    (bf16) ``weights_panel`` (kernels only). ``need_dx=False`` skips dx.
    Launches count in ``band_conv_bwd.launches`` (f32) and
    ``band_conv_bwd.launches_bf16``, in list mode in ``launches_list`` and
    ``launches_list_bf16``."""
    kw = dict(query_tile=query_tile, extent=extent, need_dx=need_dx, panel_dtype=panel_dtype,
              chunk=chunk)
    if not build.uses_kernel(impl, q_rows):
        return band_conv_bwd_plain(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                   starts, wends, gs, neighb=neighb, **kw)
    return band_conv_bwd_kernel(q_rows, thr, ptie, s_rows, x, weights, kernel_points,
                                starts, wends, gs, lists=lists, weighted=weighted,
                                weights_panel=weights_panel, **kw)


band_conv_bwd.launches = band_conv_bwd.launches_bf16 = 0
band_conv_bwd.launches_list = band_conv_bwd.launches_list_bf16 = 0


class BandConvFn(torch.autograd.Function):
    """``band_conv`` with K4 as its backward (port of
    ``d3feat_tpu/ops/pallas/band_conv.py::band_conv_ad``, threshold or
    list mode, as ``args`` say): differentiable in ``x`` and ``weights``. The density is a count
    (constant), the kernel points are buffers (no gradient).

    ``apply(x, weights, kernel_points, args, impl)`` with ``args`` the
    keyword arguments of ``band_conv`` besides those three
    (``models.blocks.band_conv_inputs``, with the search's ``lists`` on the
    kernel path, and ``panel_dtype``); returns ``out`` [Nq_pad, Cout]. On
    the kernel path the backward reuses the forward's lists and weighted
    rows."""

    @staticmethod
    def forward(ctx, x, weights, kernel_points, args, impl):
        kept = ()
        if build.uses_kernel(impl, x):
            out, den, wtd, wb = band_conv_kernel(x=x, weights=weights,
                                                 kernel_points=kernel_points,
                                                 keep_weighted=True, **args)
            kept = (wtd,) if wb is None else (wtd, wb)
        else:
            out, den = band_conv(x=x, weights=weights, kernel_points=kernel_points,
                                 impl=impl, **args)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            ctx.save_for_backward(x, weights, kernel_points, den, *kept)
        ctx.args, ctx.impl = args, impl
        return out

    @staticmethod
    def backward(ctx, g):
        x, weights, kernel_points, den, *kept = ctx.saved_tensors
        gs = (g.float() / den[:, None]).contiguous()
        kw = dict(zip(("weighted", "weights_panel"), kept))
        dx, dw = band_conv_bwd(x=x, weights=weights, kernel_points=kernel_points, gs=gs,
                               need_dx=ctx.needs_input_grad[0], impl=ctx.impl, **ctx.args, **kw)
        return dx, dw, None, None, None
