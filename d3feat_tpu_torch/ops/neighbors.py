"""Sorted-space radius search (port of the band path of
``d3feat_tpu.ops.neighbors``).

Each pyramid level is sorted once along a banding axis fixed for the whole
pyramid (``SortedLevel``); every conv, pool and upsample search touching
the level reuses the sorted state. A tile of ``T`` consecutive sorted
queries finds all its neighbors inside one contiguous window of sorted
support rows, so the K1 select kernel (``ops/select.py``) only walks that
window. The same windows feed the K2 band KPConv and the K3 head.

Rows are ``[N, 4]`` float32 (x, y, z, cloud id): support rows carry cloud id
``B`` on padding, query rows carry ``-1`` on padding so they match nothing.
"""

from __future__ import annotations

import torch

from d3feat_tpu_torch.ops.build import uses_kernel
from d3feat_tpu_torch.ops.select import band_select, fma_f32
from d3feat_tpu_torch.ops.subsample import lengths_to_cloud_ids
from d3feat_tpu_torch.utils.profiling import span

SHADOW_LIKE = 1.0e6
_BIG = 3.0e37


class SortedLevel:
    """Per-pyramid-level sorted state shared by every search at the level.

    Key = cid * KOFF + (proj - origin[cid]) as one float32 sort key (the
    same op sequence as the jitted reference, so the sorted order is
    identical);
    the sort is stable, so ties keep row order and shadow rows come last.
    """

    KOFF = 4096.0  # > any scene extent; separates clouds in the key
    EPS = 0.02     # key-resolution margin added to search windows

    def __init__(self, points: torch.Tensor, lengths: torch.Tensor,
                 num_clouds: int, axis: torch.Tensor, origin: torch.Tensor,
                 band_pad: int):
        n = points.shape[0]
        cid = lengths_to_cloud_ids(lengths, n)
        valid = cid < num_clouds
        cidc = torch.clamp(cid, max=num_clouds - 1).long()
        # the reference's sum(points * axis, 1), as XLA compiles it inside
        # the jitted pyramid: a chain of fused multiply-adds
        a = axis[cidc]
        proj = fma_f32(points[:, 2], a[:, 2],
                       fma_f32(points[:, 1], a[:, 1], points[:, 0] * a[:, 0])) - origin[cidc]
        key = cid.float() * self.KOFF + torch.clamp(proj, 0.0, self.KOFF - 1.0)
        key = torch.where(valid, key, torch.full_like(key, num_clouds * self.KOFF))

        self.num_clouds = num_clouds
        self.n = n
        self.band_pad = band_pad
        self.key_sorted, order = torch.sort(key, stable=True)
        self.order = order
        self.inv = torch.empty_like(order)
        self.inv[order] = torch.arange(n, device=order.device)
        self.pts_sorted = points[order]
        cid_sorted = torch.clamp((self.key_sorted * (1.0 / self.KOFF)).to(torch.int32),
                                 max=num_clouds)
        qcid = torch.where(self.key_sorted < num_clouds * self.KOFF, cid_sorted,
                           torch.full_like(cid_sorted, -1))
        self.q_rows = torch.cat([self.pts_sorted, qcid.float()[:, None]], 1)
        pad_rows = torch.full((band_pad, 4), SHADOW_LIKE, device=points.device)
        pad_rows[:, 3] = num_clouds
        self.s_rows = torch.cat([
            torch.cat([self.pts_sorted, cid_sorted.float()[:, None]], 1), pad_rows])


# banding-axis candidates: the 3 coordinate axes + the 4 body diagonals
_SQ3 = 0.5773502691896258
_FRAME_DIRS = (
    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
    (_SQ3, _SQ3, _SQ3), (_SQ3, _SQ3, -_SQ3),
    (_SQ3, -_SQ3, _SQ3), (-_SQ3, _SQ3, _SQ3),
)
_FRAME_DIRS_ON = {}  # device -> [7, 3] float32 _FRAME_DIRS


def frame_dirs(device) -> torch.Tensor:
    """``_FRAME_DIRS`` as a float32 tensor on ``device``, made once per
    device by fills (no copy from the host, so no wait on the device)."""
    device = torch.device(device)
    dirs = _FRAME_DIRS_ON.get(device)
    if dirs is None:
        dirs = torch.zeros((len(_FRAME_DIRS), 3), dtype=torch.float32, device=device)
        for i, row in enumerate(_FRAME_DIRS):
            for j, v in enumerate(row):
                if v:
                    dirs[i, j].fill_(v)  # item assignment would copy a host tensor
        _FRAME_DIRS_ON[device] = dirs
    return dirs


def make_level_frame(points: torch.Tensor, lengths: torch.Tensor,
                     num_clouds: int, window: float = 0.17):
    """(axis [B, 3] unit banding direction, origin [B]) per cloud: the
    candidate direction whose projected keys have the smallest maximum row
    count inside any ``window``-wide key interval (the direction along which
    the band windows are least stressed). Computed once from level 0."""
    n = points.shape[0]
    dev = points.device
    cid = lengths_to_cloud_ids(lengths, n)
    valid = cid < num_clouds
    cidc = torch.clamp(cid, max=num_clouds - 1).long()

    dirs = frame_dirs(dev)
    projs = points.float() @ dirs.T                                   # [N, D]
    masked = torch.where(valid[:, None], projs, _BIG)
    lo_proj = torch.stack([
        torch.where((cidc == b)[:, None], masked, _BIG).amin(0)
        for b in range(num_clouds)
    ])                                                                # [B, D]

    keys = cidc[:, None].float() * SortedLevel.KOFF + (projs - lo_proj[cidc])
    keys = torch.where(valid[:, None], keys, _BIG)
    stride = max(1, n // 2048)
    keys = keys[::stride]
    m = keys.shape[0]
    keys_sorted = torch.sort(keys, dim=0).values                      # per-dir columns
    cols = keys_sorted.T.contiguous()
    counts = (torch.searchsorted(cols, cols + window)
              - torch.arange(m, device=dev)).T                        # [m, D]
    cid_sorted = torch.clamp(torch.floor(keys_sorted / SortedLevel.KOFF),
                             0, num_clouds - 1).to(torch.int32)
    worst = torch.stack([
        torch.where(cid_sorted == b, counts, 0).amax(0) for b in range(num_clouds)
    ])                                                                # [B, D]
    best = torch.argmin(worst, dim=1)
    axis = dirs[best]
    origin = lo_proj.gather(1, best[:, None])[:, 0] - 1.0
    return axis, origin


def pick_chunk(band_cap: int) -> int:
    """Rows per band chunk of the reference kernels (the largest standard
    chunk dividing the cap, else the cap)."""
    for c in (256, 128, 64):
        if band_cap % c == 0:
            return c
    return band_cap


def band_windows(starts: torch.Tensor, ends: torch.Tensor, band_cap: int):
    """Per-tile support rows ``[start, wend)`` that the band kernels walk.

    Reproduces the reference kernels' window exactly: start floored to 8
    rows, end clipped to ``start + band_cap`` and rounded up to whole
    chunks, so every kernel (and its twin) sees the rows the TPU kernel saw
    even when a window overflows its cap."""
    starts = (starts.to(torch.int64) // 8) * 8
    ends = torch.minimum(torch.maximum(ends.to(torch.int64), starts), starts + band_cap)
    chunk = pick_chunk(band_cap)
    n_act = torch.clamp((ends - starts + chunk - 1) // chunk, 0, band_cap // chunk)
    return starts.to(torch.int32), (starts + n_act * chunk).to(torch.int32)


def tile_key_bounds(q_key: torch.Tensor, tile: int, num_clouds: int):
    """(kmin, kmax) of the valid sorted query keys of each ``tile``-row
    tile (+3e37 / -1 for tiles with no valid query)."""
    pad = (-q_key.shape[0]) % tile
    qk = torch.cat([q_key, q_key.new_full((pad,), _BIG)]).view(-1, tile)
    valid = qk < num_clouds * SortedLevel.KOFF
    kmin = torch.where(valid, qk, _BIG).amin(1)
    kmax = torch.where(valid, qk, -1.0).amax(1)
    return kmin, kmax


def pad_query_rows(q_rows: torch.Tensor, tile: int) -> torch.Tensor:
    """Query rows padded to a tile multiple; padding rows have cloud id -1."""
    pad = (-q_rows.shape[0]) % tile
    if not pad:
        return q_rows
    extra = q_rows.new_zeros((pad, 4))
    extra[:, 3] = -1.0
    return torch.cat([q_rows, extra])


def search_windows(q_level: SortedLevel, s_level: SortedLevel, radius: float, *,
                   query_tile: int, band_cap: int):
    """K1 inputs of one search: (padded query rows, per-tile window
    ``starts``/``wends``, r^2, overflow). A tile's window spans the support
    keys within ``radius + EPS`` of its queries' keys; ``overflow`` is set
    when a window is wider than ``band_cap``. r^2 is the float32 square of
    the float32 radius, held in a Python float: computed on the host, so no
    launch has to wait on the device to read it."""
    if s_level.band_pad < band_cap:
        raise ValueError("level band_pad < band_cap")
    r = torch.tensor(float(radius), dtype=torch.float32)  # 0-dim, on the host
    kmin, kmax = tile_key_bounds(q_level.key_sorted, query_tile, q_level.num_clouds)
    margin = r + SortedLevel.EPS
    starts = torch.searchsorted(s_level.key_sorted, kmin - margin)
    ends = torch.searchsorted(s_level.key_sorted, kmax + margin)
    starts = torch.clamp((starts // 8) * 8, max=s_level.n)
    overflow = ((ends - starts) > band_cap).any()
    starts, wends = band_windows(starts, ends, band_cap)
    return pad_query_rows(q_level.q_rows, query_tile), starts, wends, float(r * r), overflow


def radius_neighbors_sorted(q_level: SortedLevel, s_level: SortedLevel, radius: float,
                            *, max_k: int, query_tile: int, band_cap: int,
                            with_threshold: bool = False, impl: str = "auto"):
    """Band search over pre-sorted levels, in sorted space: rows stay in
    sorted-query order and values are sorted-support POSITIONS (empty ->
    ``s_level.n``).

    Returns ``(lists [Nq, max_k] int32, overflow)``, plus with
    ``with_threshold`` the per-query selection thresholds ``thr`` (the K-th
    listed squared distance, or r^2 when the list is not full) and ``ptie``
    (the largest listed position at exactly ``thr``): a support at d2 and
    position p is listed iff ``d2 < thr or (d2 == thr and p <= ptie)``.
    """
    nq, ns = q_level.n, s_level.n
    q_rows, starts, wends, r2, overflow = search_windows(
        q_level, s_level, radius, query_tile=query_tile, band_cap=band_cap)
    pos, d2 = band_select(q_rows, s_level.s_rows, starts, wends, query_tile=query_tile,
                          r2=r2, max_k=min(max_k, band_cap), impl=impl)
    out = torch.clamp(pos[:nq], max=ns)
    if out.shape[1] < max_k:
        out = torch.cat([out, out.new_full((nq, max_k - out.shape[1]), ns)], 1)
    if not with_threshold:
        return out, overflow
    thr = torch.clamp(d2[:nq, -1], max=r2)
    ptie = torch.where(d2[:nq] == thr[:, None], pos[:nq].float(), -1.0).amax(1)
    return out, overflow, thr, ptie


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a row permutation (forward only)."""
    return x[perm]


# ---------------------------------------------------------------------------
# original-order searches (the JAX package's non-band route)
# ---------------------------------------------------------------------------
#
# Every search below takes stacked contiguous clouds in their original row
# order and returns ``[Nq, max_k]`` int32 ORIGINAL support indices, ascending
# by distance, shadow = ``Ns``. They reproduce the jitted reference bit for
# bit: each d2 is computed in the op order that the JAX CPU backend compiles
# (a 3-term product or square sum is ``fma(a2, b2, fma(a1, b1, a0 * b0))``,
# a long column sum is summed in windows of 32 rows), candidates are ranked
# lowest index first among equal values (``lax.top_k``) and re-ranked by a
# stable sort (``jnp.argsort``). The float64-emulated multiply-adds and the
# explicit additions make a CUDA run equal a CPU run bit for bit too.

_INF = 3.0e38
_GRID_AX = 1024  # cells per axis of the grid search (10 bits)
_U32 = 0xFFFFFFFF


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Broadcast ``sum(a * b, -1)`` over a last axis of 3, as XLA's CPU
    backend compiles a 3-deep product: ``fma(a2, b2, fma(a1, b1, a0 * b0))``."""
    return fma_f32(a[..., 2], b[..., 2], fma_f32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def sum_rows(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """Sum over dim 0 in the order of XLA's CPU backend for a long reduced
    axis: windows of ``window`` rows are each summed in order, the axis
    zero-padded to whole windows with the odd row at the end, until at most
    ``window`` rows remain, which are then summed in order."""
    def in_order(t, dim):
        acc = t.select(dim, 0) + 0.0
        for i in range(1, t.shape[dim]):
            acc = acc + t.select(dim, i)
        return acc

    while x.shape[0] > window:
        n = x.shape[0]
        m = -(-n // window) * window
        lo = (m - n) // 2
        x = torch.cat([x.new_zeros((lo,) + x.shape[1:]), x,
                       x.new_zeros((m - n - lo,) + x.shape[1:])])
        x = in_order(x.view((m // window, window) + x.shape[1:]), 1)
    return in_order(x, 0)


def smallest_k(v: torch.Tensor, k: int, index: torch.Tensor = None):
    """``(values, indices)`` of the ``k`` smallest entries along the last
    axis, ascending, the lower index first among equal values (what
    ``lax.top_k(-v, k)`` selects); ``index`` gives each entry's index (by
    default its position). Each entry's key packs its value's ordering bits
    above its index, so the keys are distinct and any top-k gives the same
    answer."""
    bits = v.contiguous().view(torch.int32).long()
    ordered = torch.where(bits >= 0, bits, -(bits & 0x7FFFFFFF))
    if index is None:
        index = torch.arange(v.shape[-1], device=v.device).expand(v.shape)
    pos = torch.topk(ordered * (1 << 32) + index, k, dim=-1, largest=False, sorted=True).indices
    return torch.gather(v, -1, pos), torch.gather(index, -1, pos)


def _rough_d2(qt: torch.Tensor, st: torch.Tensor):
    """(``[B, T, W]`` float64 ``|q|^2 - 2 q.s + |s|^2`` of queries
    ``[B, T, 3]`` against supports ``[B, W, 3]``, ``[B, T, 1]`` bound of its
    distance from the float32 expansion that the searches compute): the
    float32 expansion rounds at most 10 times on terms of size at most
    ``|q|^2 + |s|^2``, so it lies within ``2^-18 (|q|^2 + max |s|^2)`` of
    this product of float64 operands, whose own error is far smaller."""
    qd, sd = qt.double(), st.double()
    q_n, s_n = (qd * qd).sum(-1), (sd * sd).sum(-1)
    d = torch.baddbmm(q_n[..., None] + s_n[:, None, :], qd, sd.transpose(1, 2), alpha=-2.0)
    s_max = s_n.amax(-1)[:, None, None] if s_n.shape[-1] else 0.0
    return d, 2.0**-18 * (q_n[..., None] + s_max)


def nearest_by_expansion(qt, qt_cid, st, st_cid, s_sq, k: int):
    """``smallest_k`` of the float32 expansion ``(|q|^2 - 2 q.s) + |s|^2``
    of tiles of queries ``qt`` ``[B, T, 3]`` against their supports ``st``
    ``[B, W, 3]`` (cloud ids ``qt_cid``, ``st_cid``; ``s_sq`` the supports'
    ``|s|^2``), other clouds at 3e38: the reference's candidate ``top_k``.
    The expansion is computed only for the candidates that can rank: a
    float64 product (``_rough_d2``) bounds every entry, and an entry more
    than twice the bound above the row's k-th float64 value lies above all
    of the row's k smallest expansions. Returns ``[B, T, k]`` values and
    support columns."""
    d, tol = _rough_d2(qt, st)
    same = qt_cid[..., :, None] == st_cid[..., None, :]
    d = torch.where(same, d, torch.inf)
    kth = torch.topk(d, k, dim=-1, largest=False).values[..., -1:]
    cand = same & (d <= kth + 2.0 * tol)
    with span("sync.candidates"):
        m = max(k, int(cand.sum(-1).max()))
    idx = torch.topk(torch.where(cand, d, torch.inf), m, dim=-1, largest=False).indices
    flat = idx + (torch.arange(st.shape[0], device=st.device) * st.shape[1])[:, None, None]
    d2 = (dot3(qt, qt)[..., None] - 2.0 * dot3(qt[..., None, :], st.reshape(-1, 3)[flat])) \
        + s_sq.reshape(-1)[flat]
    d2 = torch.where(torch.gather(cand, -1, idx), d2, _INF)
    return smallest_k(d2, k, idx)


def _rerank(cand_d2, sel, valid, r2: float, shadow_of):
    """The exact re-rank of a candidate set: keep the candidates with
    ``valid`` and exact ``cand_d2 <= r2``, order them by exact d2 (stable),
    the rest become ``shadow_of`` (the caller's empty value)."""
    keep = valid & (cand_d2 <= r2)
    d2e = torch.where(keep, cand_d2, torch.full_like(cand_d2, _INF))
    rank = torch.sort(d2e, dim=-1, stable=True).indices
    sel = torch.gather(sel, -1, rank)
    keep = torch.gather(keep, -1, rank)
    return torch.where(keep, sel, torch.full_like(sel, shadow_of))


def _pad_rows(x: torch.Tensor, n: int, value=0):
    if n == 0:
        return x
    return torch.cat([x, x.new_full((n,) + x.shape[1:], value)])


def _clouds(q_lengths, s_lengths, nq: int, ns: int, num_clouds: int):
    q_cid = lengths_to_cloud_ids(q_lengths, nq)
    s_cid = lengths_to_cloud_ids(s_lengths, ns)
    return q_cid, s_cid, q_cid < num_clouds, s_cid < num_clouds


def _scene_center(queries, q_valid, q_lengths):
    """The queries' mean, the reference's centring of the d2 expansion."""
    total = torch.clamp(q_lengths.sum(), min=1).float()
    return sum_rows(torch.where(q_valid[:, None], queries, 0.0)) / total


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _finish(out: torch.Tensor, max_k: int, ns: int) -> torch.Tensor:
    if out.shape[1] < max_k:
        out = torch.cat([out, out.new_full((out.shape[0], max_k - out.shape[1]), ns)], 1)
    return out.to(torch.int32)


_PANEL = 1 << 24  # entries of one step's [rows, supports] panel


def _row_groups(qcid_p, s_lengths, query_tile: int):
    """Steps of the brute searches: ``(r0, r1, lo, hi)``, rows ``[r0, r1)``
    of whole query tiles against the support rows ``[lo, hi)`` of the
    clouds their valid queries belong to (clouds are stacked contiguously;
    every other support is of another cloud, which the searches never list
    or count). Consecutive tiles with the same support rows share a step
    while the panel stays within ``_PANEL`` entries; a tile without a valid
    query gets ``lo == hi``."""
    cid = qcid_p.view(-1, query_tile).long()
    valid = cid >= 0
    with span("sync.row_groups"):
        c_lo = torch.where(valid, cid, 1 << 30).amin(1).tolist()
    with span("sync.row_groups"):
        c_hi = torch.where(valid, cid, -1).amax(1).tolist()
    with span("sync.row_groups"):
        ends = [0] + torch.cumsum(s_lengths.long(), 0).tolist()
    steps = []
    for t, (a, b) in enumerate(zip(c_lo, c_hi)):
        lo, hi = (ends[a], ends[b + 1]) if b >= 0 else (0, 0)
        r0, r1 = t * query_tile, (t + 1) * query_tile
        if steps and steps[-1][2:] == [lo, hi] and \
                (r1 - steps[-1][0]) * max(hi - lo, 1) <= _PANEL:
            steps[-1][1] = r1
        else:
            steps.append([r0, r1, lo, hi])
    return steps


def radius_neighbors(queries, supports, q_lengths, s_lengths, radius: float, *,
                     max_k: int, num_clouds: int, query_tile: int = 1024) -> torch.Tensor:
    """Brute search (``d3feat_tpu/ops/neighbors.py::radius_neighbors``):
    per tile of queries, the ``min(max_k, Ns)`` candidates nearest by the
    expansion ``|q|^2 - 2 q.s + |s|^2`` around the queries' centre
    (``nearest_by_expansion``), then an exact re-rank. ``[Nq, max_k]``
    int32 original indices, shadow ``Ns``.
    Each tile ranks only the supports of its queries' clouds
    (``_row_groups``, several tiles a step): the reference's candidates
    from other clouds are never kept, so they only ever become shadow
    slots."""
    nq, ns = queries.shape[0], supports.shape[0]
    r = f32(radius)
    r2 = f32(r * r)
    q_cid, s_cid, q_valid, s_valid = _clouds(q_lengths, s_lengths, nq, ns, num_clouds)
    q_cid = torch.where(q_valid, q_cid, -1)
    center = _scene_center(queries.float(), q_valid, q_lengths)
    qc = torch.where(q_valid[:, None], queries.float() - center, 0.0)
    sc = torch.where(s_valid[:, None], supports.float() - center, 0.0)
    s_sq = dot3(sc, sc)
    k = min(max_k, ns)
    pad = (-nq) % query_tile
    qc_p, qcid_p = _pad_rows(qc, pad), _pad_rows(q_cid, pad, -1)
    tiles = []
    for r0, r1, lo, hi in _row_groups(qcid_p, s_lengths, query_tile):
        qt, qt_cid = qc_p[r0:r1], qcid_p[r0:r1]
        out = qt_cid.new_full((r1 - r0, k), ns, dtype=torch.long)
        if hi > lo:
            sct = sc[lo:hi]
            vals, sel = nearest_by_expansion(qt[None], qt_cid[None], sct[None], s_cid[None, lo:hi],
                                             s_sq[None, lo:hi], min(k, hi - lo))
            diff = sct[sel[0]] - qt[:, None, :]
            out[:, :sel.shape[2]] = _rerank(dot3(diff, diff), sel[0] + lo, vals[0] < _INF, r2, ns)
        tiles.append(out)
    return _finish(torch.cat(tiles)[:nq], max_k, ns)


def _band_sort(queries, supports, q_lengths, s_lengths, radius: float, num_clouds: int):
    """The banded searches' shared preparation: keys along the supports'
    banding axis (``make_level_frame`` at window ``2 r + 0.04``) from the
    joint per-cloud origin, and both clouds sorted by them (stable)."""
    nq, ns = queries.shape[0], supports.shape[0]
    q_cid, s_cid, q_valid, s_valid = _clouds(q_lengths, s_lengths, nq, ns, num_clouds)
    r = f32(radius)
    axis, _ = make_level_frame(supports, s_lengths, num_clouds,
                               window=f32(f32(2.0 * r) + f32(0.04)))
    qf, sf = queries.float(), supports.float()
    cidc_q = torch.clamp(q_cid, max=num_clouds - 1).long()
    cidc_s = torch.clamp(s_cid, max=num_clouds - 1).long()
    proj_q, proj_s = dot3(qf, axis[cidc_q]), dot3(sf, axis[cidc_s])

    def cloud_min(proj, cidc, valid):
        m = torch.where(valid, proj, _BIG)
        return torch.stack([torch.where(cidc == b, m, _BIG).amin() for b in range(num_clouds)])

    origin = torch.minimum(cloud_min(proj_q, cidc_q, q_valid), cloud_min(proj_s, cidc_s, s_valid))
    koff = SortedLevel.KOFF

    def keys_of(proj, cid, cidc, valid):
        p = torch.clamp(proj - origin[cidc], 0.0, koff - 1.0)
        return torch.where(valid, cid.float() * koff + p, num_clouds * koff)

    q_key = keys_of(proj_q, q_cid, cidc_q, q_valid)
    s_key = keys_of(proj_s, s_cid, cidc_s, s_valid)
    qk, qord = torch.sort(q_key, stable=True)
    sk, sord = torch.sort(s_key, stable=True)
    return dict(qk=qk, qord=qord, sk=sk, sord=sord, qs=qf[qord],
                qcid_s=torch.where(q_valid, q_cid, -1)[qord], ss=sf[sord], scid_s=s_cid[sord],
                q_valid=q_valid, r=r)


def _band_tiles(qk, qcid_s, nq: int, query_tile: int, num_clouds: int):
    """Per-tile (kmin, kmax) of the sorted valid query keys, padded."""
    pad = (-nq) % query_tile
    qk_p = _pad_rows(qk, pad, float((num_clouds + 1) * SortedLevel.KOFF))
    qcid_p = _pad_rows(qcid_s, pad, -1)
    tiles = qk_p.view(-1, query_tile)
    tvalid = qcid_p.view(-1, query_tile) >= 0
    kmin = torch.where(tvalid, tiles, 3.0e37).amin(1)
    kmax = torch.where(tvalid, tiles, -3.0e37).amax(1)
    return pad, kmin, kmax


def radius_neighbors_banded(queries, supports, q_lengths, s_lengths, radius: float, *,
                            max_k: int, num_clouds: int, query_tile: int = 1024,
                            band_cap: int = 4096):
    """Banded search (``d3feat_tpu/ops/neighbors.py::radius_neighbors_banded``):
    both clouds sorted along the supports' banding axis; each tile of sorted
    queries ranks the ``band_cap`` sorted supports from the first one whose
    key is within ``r + 0.02`` of the tile's smallest key, by the centred
    expansion, then re-ranks exactly. Returns (``[Nq, max_k]`` int32
    original indices, shadow ``Ns``, in the original query order;
    ``overflow``: some tile's window was wider than ``band_cap``)."""
    nq, ns = queries.shape[0], supports.shape[0]
    st = _band_sort(queries, supports, q_lengths, s_lengths, radius, num_clouds)
    r = st["r"]
    r2 = f32(r * r)
    eps = f32(SortedLevel.EPS)
    shadow_pos = ns + band_cap - 1
    ss_pad = _pad_rows(st["ss"], band_cap, SHADOW_LIKE)
    scid_pad = _pad_rows(st["scid_s"], band_cap, num_clouds)
    sidx_pad = _pad_rows(st["sord"].to(torch.int32), band_cap, ns)
    center = _scene_center(queries.float(), st["q_valid"], q_lengths)
    qs_c = torch.where((st["qcid_s"] >= 0)[:, None], st["qs"] - center, 0.0)
    ss_c = torch.where((scid_pad < num_clouds)[:, None], ss_pad - center, 0.0)
    pad, kmin, kmax = _band_tiles(st["qk"], st["qcid_s"], nq, query_tile, num_clouds)
    lo = torch.searchsorted(st["sk"], (kmin - r) - eps)
    hi = torch.searchsorted(st["sk"], (kmax + r) + eps)
    overflow = ((hi - lo) > band_cap).any()
    qc_p, qcid_p = _pad_rows(qs_c, pad), _pad_rows(st["qcid_s"], pad, -1)
    k = min(max_k, band_cap)
    offs = torch.arange(band_cap, device=queries.device)
    n_tiles = (nq + pad) // query_tile
    qc_t, qcid_t = qc_p.view(n_tiles, query_tile, 3), qcid_p.view(n_tiles, query_tile)
    step = max(1, _PANEL // (query_tile * band_cap))  # tiles a step, each in its own window
    tiles = []
    for t0 in range(0, n_tiles, step):
        qt, qt_cid, tlo = qc_t[t0:t0 + step], qcid_t[t0:t0 + step], lo[t0:t0 + step]
        rows = tlo[:, None] + offs                                           # [b, band_cap]
        band = ss_c[rows]
        vals, sel = nearest_by_expansion(qt, qt_cid, band, scid_pad[rows], dot3(band, band), k)
        diff = ss_c[sel + tlo[:, None, None]] - qt[:, :, None, :]
        tiles.append(_rerank(dot3(diff, diff), sel + tlo[:, None, None], vals < _INF, r2,
                             shadow_pos).reshape(-1, k))
    pos = torch.cat(tiles)[:nq]
    out = _finish(sidx_pad[torch.clamp(pos, max=shadow_pos)], max_k, ns)
    return out[_inverse(st["qord"])], overflow


def unsorted_select_args(queries, supports, q_lengths, s_lengths, radius: float, *,
                         max_k: int, num_clouds: int, query_tile: int = 256,
                         band_cap: int = 2048) -> dict:
    """The K1 call that ``radius_neighbors_pallas`` makes: the banded
    search's keys and stable sorts; sorted query rows (cloud id -1 on
    padding) and supports with ``band_cap`` shadow rows; each tile's window
    from its key bounds, start floored to 8 rows (``band_windows``). Returns
    ``band_select``'s arguments (``q_rows``, ``s_rows``, ``starts``,
    ``wends``, ``query_tile``, ``r2``, ``max_k``) and, to map its output
    back, ``sidx_pad`` (original index of each sorted support, shadow past
    them), ``qord`` and ``overflow``."""
    nq, ns = queries.shape[0], supports.shape[0]
    st = _band_sort(queries, supports, q_lengths, s_lengths, radius, num_clouds)
    r = st["r"]
    eps = f32(SortedLevel.EPS)
    s_rows = torch.cat([_pad_rows(st["ss"], band_cap, SHADOW_LIKE),
                        _pad_rows(st["scid_s"], band_cap, num_clouds).float()[:, None]], 1)
    pad, kmin, kmax = _band_tiles(st["qk"], st["qcid_s"], nq, query_tile, num_clouds)
    starts = torch.searchsorted(st["sk"], (kmin - r) - eps)
    ends = torch.searchsorted(st["sk"], (kmax + r) + eps)
    starts = torch.clamp((starts // 8) * 8, max=ns)
    overflow = ((ends - starts) > band_cap).any()
    starts, wends = band_windows(starts, ends, band_cap)
    q_rows = torch.cat([_pad_rows(st["qs"], pad),
                        _pad_rows(st["qcid_s"], pad, -1).float()[:, None]], 1)
    return dict(q_rows=q_rows.contiguous(), s_rows=s_rows.contiguous(),
                starts=starts.contiguous(), wends=wends.contiguous(), query_tile=query_tile,
                r2=f32(r * r), max_k=min(max_k, band_cap),
                sidx_pad=_pad_rows(st["sord"].to(torch.int32), band_cap, ns),
                qord=st["qord"], overflow=overflow)


def radius_neighbors_pallas(queries, supports, q_lengths, s_lengths, radius: float, *,
                            max_k: int, num_clouds: int, query_tile: int = 256,
                            band_cap: int = 2048, impl: str = "auto"):
    """K1 on clouds that are not pre-sorted
    (``d3feat_tpu/ops/neighbors.py::radius_neighbors_pallas``): the K1
    select (``ops.select.band_select``: the kernel on CUDA tensors, its twin
    on CPU ones, ``impl`` as there) over the sorted supports of
    ``unsorted_select_args``. Returns (``[Nq, max_k]`` int32 original
    indices, shadow ``Ns``, in the original query order; ``overflow``: some
    tile's window was wider than ``band_cap``). ``launches`` counts the
    calls that launched the kernel."""
    kernel = uses_kernel(impl, queries)
    nq, ns = queries.shape[0], supports.shape[0]
    a = unsorted_select_args(queries, supports, q_lengths, s_lengths, radius, max_k=max_k,
                             num_clouds=num_clouds, query_tile=query_tile, band_cap=band_cap)
    kw = {k: a[k] for k in ("q_rows", "s_rows", "starts", "wends", "query_tile", "r2", "max_k")}
    pos, _ = band_select(impl=impl, **kw)
    if kernel:
        radius_neighbors_pallas.launches += 1
    out = _finish(a["sidx_pad"][torch.clamp(pos[:nq].long(), max=ns + band_cap - 1)], max_k, ns)
    return out[_inverse(a["qord"])], a["overflow"]


radius_neighbors_pallas.launches = 0


def _grid_pack(cid: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """The grid's uint32 cell key ``((cid * AX + c0) * AX + c1) * AX + c2``,
    wrapping as uint32 arithmetic wraps (held in int64)."""
    k = cid.long() & _U32
    for ax in range(3):
        k = (k * _GRID_AX + (cell[..., ax].long() & _U32)) & _U32
    return k


def radius_neighbors_grid(queries, supports, q_lengths, s_lengths, radius: float, *,
                          max_k: int, num_clouds: int, query_tile: int = 1024,
                          cell_capacity: int = 32):
    """Cell-grid search (``d3feat_tpu/ops/neighbors.py::radius_neighbors_grid``):
    supports bucketed into cubic cells of edge ``radius`` from the joint
    per-cloud origin, sorted by cell key; each query ranks the first
    ``cell_capacity`` supports of each of its 27 neighbouring cells by exact
    d2. Cell coordinates multiply by the float32 reciprocal of the radius,
    as the jitted reference computes its division by a constant radius.
    Returns (``[Nq, max_k]`` int32 original indices, shadow ``Ns``;
    ``overflow``: a cell held more than ``cell_capacity`` supports)."""
    nq, ns = queries.shape[0], supports.shape[0]
    dev = queries.device
    r = f32(radius)
    r2 = f32(r * r)
    inv_r = float(torch.tensor(1.0) / torch.tensor(r))  # float32 division
    q_cid, s_cid, q_valid, s_valid = _clouds(q_lengths, s_lengths, nq, ns, num_clouds)
    qf, sf = queries.float(), supports.float()

    def seg_min(pts, cid, valid):
        m = torch.where(valid[:, None], pts, 3.0e37)
        cidc = torch.clamp(cid, max=num_clouds - 1)
        return torch.stack([torch.where((cidc == b)[:, None], m, 3.0e37).amin(0)
                            for b in range(num_clouds)])

    origin = torch.minimum(seg_min(qf, q_cid, q_valid), seg_min(sf, s_cid, s_valid))

    def cell_of(pts, cid, valid):
        o = origin[torch.clamp(cid, max=num_clouds - 1).long()]
        c = torch.floor((pts - o) * inv_r).to(torch.int32)
        c = torch.clamp(c + 1, 0, _GRID_AX - 1)
        return torch.where(valid[:, None], c, _GRID_AX - 1)

    s_key = _grid_pack(torch.where(s_valid, s_cid, num_clouds), cell_of(sf, s_cid, s_valid))
    sk, order = torch.sort(s_key, stable=True)
    sp, sidx = sf[order], order.to(torch.int32)
    is_first = torch.ones(ns, dtype=torch.bool, device=dev)
    is_first[1:] = sk[1:] != sk[:-1]
    run_id = torch.cumsum(is_first.long(), 0) - 1
    run_len = torch.zeros(ns, dtype=torch.long, device=dev).index_add_(
        0, run_id, s_valid[order].long())
    overflow = run_len.max() > cell_capacity

    q_cell = cell_of(qf, q_cid, q_valid)
    q_key_cid = torch.where(q_valid, q_cid, num_clouds + 1)
    rng3 = torch.arange(-1, 2, device=dev)
    offs = torch.stack(torch.meshgrid(rng3, rng3, rng3, indexing="ij"), -1).reshape(27, 3)
    m = cell_capacity
    pad = (-nq) % query_tile
    qc_p = _pad_rows(q_cell, pad)
    qcid_p = _pad_rows(q_key_cid, pad, num_clouds + 1)
    qp_p = _pad_rows(qf, pad)
    k = min(max_k, 27 * m)
    step = query_tile * max(1, _PANEL // (query_tile * 27 * m))  # rows are independent
    tiles = []
    for t0 in range(0, nq + pad, step):
        qc, qcid, qp = (a[t0:t0 + step] for a in (qc_p, qcid_p, qp_p))
        key = _grid_pack(qcid[:, None].expand(-1, 27), qc[:, None, :] + offs[None])  # [R, 27]
        start = torch.searchsorted(sk, key.reshape(-1)).view(key.shape)
        pos = start[:, :, None] + torch.arange(m, device=dev)                       # [R, 27, m]
        pos_c = torch.clamp(pos, max=ns - 1)
        hit = ((sk[pos_c] == key[:, :, None]) & (pos < ns)).reshape(-1, 27 * m)
        pos_c = pos_c.reshape(-1, 27 * m)
        diff = sp[pos_c] - qp[:, None, :]
        d2 = dot3(diff, diff)
        d2 = torch.where(hit & (d2 <= r2), d2, _INF)
        vals, sel = smallest_k(d2, k)
        idx = torch.gather(sidx[pos_c], 1, sel)
        tiles.append(torch.where(vals < _INF, idx, ns))
    return _finish(torch.cat(tiles)[:nq], max_k, ns), overflow


def count_in_radius(queries, supports, q_lengths, s_lengths, radius: float, *,
                    num_clouds: int, query_tile: int = 1024) -> torch.Tensor:
    """``[Nq]`` int32 count of same-cloud supports within ``radius`` of each
    query, by the uncentred float32 expansion
    (``d3feat_tpu/ops/neighbors.py::count_in_radius``); the neighbour-cap
    calibration's histogram. Each tile reads only the supports of its
    queries' clouds (``_row_groups``) and decides every pair from a
    float64 product (``_rough_d2``) except those within the bound of the
    radius, whose float32 expansion it computes as the reference does."""
    nq, ns = queries.shape[0], supports.shape[0]
    r = f32(radius)
    r2 = f32(r * r)
    q_cid, s_cid, q_valid, _ = _clouds(q_lengths, s_lengths, nq, ns, num_clouds)
    q_cid = torch.where(q_valid, q_cid, -1)
    pad = (-nq) % query_tile
    q_p, qcid_p = _pad_rows(queries.float(), pad), _pad_rows(q_cid, pad, -1)
    sc = supports.float()
    s_sq = dot3(sc, sc)
    out = []
    for r0, r1, lo, hi in _row_groups(qcid_p, s_lengths, query_tile):
        qt, qt_cid = q_p[r0:r1], qcid_p[r0:r1]
        d, tol = _rough_d2(qt[None], sc[None, lo:hi])
        d, tol = d[0], tol[0]
        same = qt_cid[:, None] == s_cid[None, lo:hi]
        cnt = (same & (d <= r2 - tol)).sum(1)
        i, j = torch.nonzero(same & ((d - r2).abs() <= tol), as_tuple=True)
        qi, sj = qt[i], sc[lo + j]
        d2 = (dot3(qi, qi) - 2.0 * dot3(qi, sj)) + s_sq[lo + j]
        out.append(cnt.index_add_(0, i, (d2 <= r2).long()))
    return torch.cat(out)[:nq].to(torch.int32)
