"""List stage of K2 and K4: each query's selected support rows, built once
per search and shared by every band conv of the search and its backward.

For each padded query of a tile, the rows of the tile's window that the
threshold rule selects (``band_conv.threshold_select``: same cloud id and
``d2 < thr`` or ``d2 == thr`` and position ``<= ptie``, which reproduces
the query's K1 list), in ascending position: ``lpos`` [Nq_pad, L] int32
(-1 past the count), ``ld2`` [Nq_pad, L] float32, their exact squared
distances (0 past the count), and ``lcnt`` [Nq_pad] int32. ``L``, the
lists' width, is the search's cap K rounded up to 64, 128 or 256
(``list_width``): K1 keeps at most 256 rows a query.

List mode (``band_lists_given``), for a search without thresholds (the
TPU kernels' ``use_thr=False``): the same lists built from the search's
own position lists ``neighb`` [K, Nq_pad] instead: the listed positions
inside the tile's window, in ascending position, a repeated position once
per listing; ``ld2`` is None, as list mode weighs a pair from its
coordinates alone (``band_conv.list_weights``).

For K4's dx pass the lists are also transposed (``transpose_lists``):
for each support row, the flat entries ``q * L + j`` that list it, in
ascending query order. Built at first use and kept with the lists.

The kernels are in ``ops/cuda/band_lists.cu``; ``band_lists_plain``,
``band_lists_given_plain`` and ``transpose_lists_plain`` are their twins.
"""

from __future__ import annotations

import ctypes

import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.ops.select import tile_windows
from d3feat_tpu_torch.utils.profiling import span

LCAP = 64   # the narrowest lists' width (band_lists.cuh: LSEG)
LMAX = 256  # the widest (K1's largest cap)
QB = 32     # queries per CTA of the kernel: tiles are multiples of it


def list_width(k: int) -> int:
    """The width of the lists of a search of cap ``k``: the first of 64,
    128 and 256 that holds ``k`` entries (a power of two, so the kernels
    find an entry's query by a shift)."""
    for width in (LCAP, 2 * LCAP, LMAX):
        if k <= width:
            return width
    raise ValueError(f"list_width: K = {k} listed positions > LMAX = {LMAX}")


class BandLists:
    """The lists of one search, and their transpose once K4 asked for it.
    ``mode`` is the selection they came from, ``"threshold"`` or
    ``"list"`` (no ``ld2``), and decides how K2 and K4 weigh them."""

    def __init__(self, lpos: torch.Tensor, ld2, lcnt: torch.Tensor, mode: str = "threshold"):
        if mode not in ("threshold", "list") or (ld2 is None) != (mode == "list"):
            raise ValueError(f"BandLists: mode {mode!r} with ld2 {type(ld2).__name__}")
        self.lpos, self.ld2, self.lcnt, self.mode = lpos, ld2, lcnt, mode
        self._transposes = {}

    @property
    def width(self) -> int:
        """Entries a query (``list_width`` of the search's cap)."""
        return self.lpos.shape[1]

    def transpose(self, n_rows: int, impl: str = "auto"):
        """``transpose_lists(self, n_rows, impl)``, built once for each row
        count and route (kernel or twin) and kept."""
        key = (n_rows, build.uses_kernel(impl, self.lpos))
        if key not in self._transposes:
            self._transposes[key] = transpose_lists(self, n_rows, impl=impl)
        return self._transposes[key]


def transpose_lists_plain(lists: BandLists, n_rows: int):
    """Twin of the transpose kernel: a stable sort of the entries by row
    keeps their (query, position) order."""
    flat = lists.lpos.reshape(-1)
    keys = torch.where(flat >= 0, flat, n_rows)  # unused entries sort last
    rows, pairs = torch.sort(keys, stable=True)
    bounds = torch.arange(n_rows + 1, device=flat.device, dtype=rows.dtype)
    row_ptr = torch.searchsorted(rows, bounds).to(torch.int32)
    pairs = pairs.to(torch.int32)
    with span("sync.transpose_end"):
        end = int(row_ptr[-1])
    pairs[end:] = 0  # past the entries: unused
    return row_ptr, pairs


_TRANSPOSE_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6


def transpose_lists_kernel(lists: BandLists, n_rows: int):
    """Launch the transpose kernels (same contract as ``transpose_lists_plain``)."""
    i32 = torch.int32
    build.require(lists.lpos, i32, "lpos")
    build.require(lists.lcnt, i32, "lcnt")
    nq = lists.lcnt.shape[0]
    dev = lists.lpos.device
    counts = torch.zeros((2, n_rows), dtype=i32, device=dev)  # per-row counts, fill cursors
    row_ptr = torch.empty((n_rows + 1,), dtype=i32, device=dev)
    filled = torch.empty((nq * lists.width,), dtype=i32, device=dev)
    pairs = torch.zeros((nq * lists.width,), dtype=i32, device=dev)
    fn = build.launcher("band_lists", "band_lists_transpose_launch", _TRANSPOSE_ARGS)
    rc = fn(build.ptr(lists.lpos), build.ptr(lists.lcnt), nq, n_rows, lists.width,
            build.ptr(counts[0]),
            build.ptr(counts[1]), build.ptr(row_ptr), build.ptr(filled), build.ptr(pairs),
            build.stream_of(lists.lpos))
    build.check(rc, "transpose_lists_kernel")
    transpose_lists.launches += 1
    return row_ptr, pairs


def transpose_lists(lists: BandLists, n_rows: int, impl: str = "auto"):
    """(row_ptr [n_rows + 1] int32, pairs [Nq_pad * L] int32): the
    entries of support row r are ``pairs[row_ptr[r]:row_ptr[r + 1]]``,
    ascending; ``pairs`` is zero past ``row_ptr[n_rows]``."""
    if build.uses_kernel(impl, lists.lpos):
        return transpose_lists_kernel(lists, n_rows)
    return transpose_lists_plain(lists, n_rows)


transpose_lists.launches = 0


def band_lists_plain(q_rows, thr, ptie, s_rows, starts, wends, *, query_tile: int,
                     width: int = LCAP):
    """Twin of the list-stage kernel (same contract), in plain PyTorch."""
    from d3feat_tpu_torch.ops.band_conv import threshold_select

    nq = q_rows.shape[0]
    n = nq // query_tile
    dev = q_rows.device
    width = list_width(width)
    lpos = torch.full((nq, width), -1, dtype=torch.int32, device=dev)
    ld2 = torch.zeros((nq, width), dtype=torch.float32, device=dev)
    if n == 0:
        return BandLists(lpos, ld2, torch.zeros((nq,), dtype=torch.int32, device=dev))
    rows, pos, inside = tile_windows(s_rows, starts, wends)         # [n, W, 4]
    sel, d2 = threshold_select(rows, pos, inside, q_rows, thr, ptie, query_tile)
    sel, d2 = sel.reshape(nq, -1), d2.reshape(nq, -1)               # [Nq, W]
    # selected entries first, each group in window (= position) order
    order = torch.sort((~sel).to(torch.int8), dim=1, stable=True).indices[:, :width]
    k = order.shape[1]
    cnt = sel.sum(1).clamp(max=width)
    keep = torch.arange(k, device=dev)[None, :] < cnt[:, None]
    p = torch.gather(pos.repeat_interleave(query_tile, 0), 1, order)
    lpos[:, :k] = torch.where(keep, p, -1).to(torch.int32)
    ld2[:, :k] = torch.where(keep, torch.gather(d2, 1, order), 0.0)
    return BandLists(lpos, ld2, cnt.to(torch.int32))


_LISTS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4


def band_lists_kernel(q_rows, thr, ptie, s_rows, starts, wends, *, query_tile: int,
                      width: int = LCAP):
    """Launch the list-stage CUDA kernel (same contract as ``band_lists_plain``)."""
    f32, i32 = torch.float32, torch.int32
    for t, dt, name in ((q_rows, f32, "q_rows"), (thr, f32, "thr"), (ptie, f32, "ptie"),
                        (s_rows, f32, "s_rows"), (starts, i32, "starts"), (wends, i32, "wends")):
        build.require(t, dt, name)
    nq = q_rows.shape[0]
    if nq % query_tile or query_tile % QB or starts.shape[0] != nq // query_tile:
        raise ValueError("band_lists: bad tile/shape arguments")
    dev = q_rows.device
    width = list_width(width)
    lpos = torch.empty((nq, width), dtype=i32, device=dev)
    ld2 = torch.empty((nq, width), dtype=f32, device=dev)
    lcnt = torch.empty((nq,), dtype=i32, device=dev)
    fn = build.launcher("band_lists", "band_lists_launch", _LISTS_ARGS)
    rc = fn(build.ptr(q_rows), build.ptr(thr), build.ptr(ptie), build.ptr(s_rows),
            build.ptr(starts), build.ptr(wends), nq, query_tile, width, build.ptr(lpos),
            build.ptr(ld2), build.ptr(lcnt), build.stream_of(q_rows))
    build.check(rc, "band_lists_kernel")
    band_lists.launches += 1
    return BandLists(lpos, ld2, lcnt)


def band_lists(q_rows, thr, ptie, s_rows, starts, wends, *, query_tile: int,
               width: int = LCAP, impl: str = "auto") -> BandLists:
    """The lists of one search: ``q_rows`` [Nq_pad, 4] sorted queries with
    their ``thr``/``ptie`` [Nq_pad] (padding: cloud id -1, which lists
    nothing), ``s_rows`` [Ns_pad, 4] sorted supports, windows
    ``starts``/``wends`` [n_tiles], ``width`` the search's cap K (the lists
    are ``list_width(width)`` wide). ``impl`` as in ``ops.select.band_select``."""
    kw = dict(query_tile=query_tile, width=width)
    if build.uses_kernel(impl, q_rows):
        return band_lists_kernel(q_rows, thr, ptie, s_rows, starts, wends, **kw)
    return band_lists_plain(q_rows, thr, ptie, s_rows, starts, wends, **kw)


band_lists.launches = 0


def band_lists_given_plain(neighb, starts, wends, *, query_tile: int, n_rows: int) -> BandLists:
    """Twin of the list-mode list stage (same contract as ``band_lists_given``)."""
    k, nq = neighb.shape
    width = list_width(k)
    dev = neighb.device
    p = neighb.T.long()                                             # [Nq, K]
    tile = torch.arange(nq, device=dev) // query_tile
    ws = starts.long()[tile][:, None]
    we = torch.clamp(wends.long(), max=n_rows)[tile][:, None]
    keep = (p >= ws) & (p < we)
    key = torch.where(keep, p, torch.iinfo(torch.int64).max)
    key, order = torch.sort(key, dim=1, stable=True)                # ascending (position, k)
    cnt = keep.sum(1)
    lpos = torch.full((nq, width), -1, dtype=torch.int32, device=dev)
    lpos[:, :k] = torch.where(torch.arange(k, device=dev)[None, :] < cnt[:, None], key,
                              -1).to(torch.int32)
    return BandLists(lpos, None, cnt.to(torch.int32), mode="list")


_GIVEN_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 2 + [
    ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def band_lists_given_kernel(neighb, starts, wends, *, query_tile: int, n_rows: int) -> BandLists:
    """Launch the list-mode list-stage kernel (same contract as
    ``band_lists_given_plain``)."""
    i32 = torch.int32
    for t, name in ((neighb, "neighb"), (starts, "starts"), (wends, "wends")):
        build.require(t, i32, name)
    k, nq = neighb.shape
    width = list_width(k)
    if nq % query_tile or starts.shape[0] != nq // query_tile:
        raise ValueError("band_lists_given: bad tile/shape arguments")
    dev = neighb.device
    lpos = torch.empty((nq, width), dtype=i32, device=dev)
    lcnt = torch.empty((nq,), dtype=i32, device=dev)
    fn = build.launcher("band_lists", "band_lists_given_launch", _GIVEN_ARGS)
    rc = fn(build.ptr(neighb), k, nq, build.ptr(starts), build.ptr(wends), query_tile, n_rows,
            width, build.ptr(lpos), build.ptr(lcnt), build.stream_of(neighb))
    build.check(rc, "band_lists_given_kernel")
    band_lists_given.launches += 1
    return BandLists(lpos, None, lcnt, mode="list")


def band_lists_given(neighb, starts, wends, *, query_tile: int, n_rows: int,
                     impl: str = "auto") -> BandLists:
    """The list-mode lists of one search from its position lists ``neighb``
    [K, Nq_pad] int32 (``neighbors[l].T`` or ``pools[l].T``, padded
    queries listing the shadow ``n_rows``), windows ``starts``/``wends``
    [n_tiles]: each query's positions p with ``start <= p < wend`` (the
    rows the TPU kernel's chunk loop sees) and ``p < n_rows`` (the rows
    from ``n_rows`` on are zero pads: they add exactly 0 to out, den and
    dW, and their dx is dropped by the caller), ascending, a repeated
    position once per listing, ``list_width(K)`` entries a query. Raises
    for ``K > LMAX``. ``impl`` as in
    ``ops.select.band_select``."""
    kw = dict(query_tile=query_tile, n_rows=n_rows)
    if build.uses_kernel(impl, neighb):
        return band_lists_given_kernel(neighb, starts, wends, **kw)
    return band_lists_given_plain(neighb, starts, wends, **kw)


band_lists_given.launches = 0
