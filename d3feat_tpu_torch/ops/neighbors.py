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

from d3feat_tpu_torch.ops.select import band_select, fma_f32
from d3feat_tpu_torch.ops.subsample import lengths_to_cloud_ids

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
    big = torch.tensor(_BIG, device=dev)

    dirs = torch.tensor(_FRAME_DIRS, dtype=torch.float32, device=dev)
    projs = points.float() @ dirs.T                                   # [N, D]
    masked = torch.where(valid[:, None], projs, big)
    lo_proj = torch.stack([
        torch.where((cidc == b)[:, None], masked, big).amin(0)
        for b in range(num_clouds)
    ])                                                                # [B, D]

    keys = cidc[:, None].float() * SortedLevel.KOFF + (projs - lo_proj[cidc])
    keys = torch.where(valid[:, None], keys, big)
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
    ptie = torch.where(d2[:nq] == thr[:, None], pos[:nq].float(),
                       torch.tensor(-1.0, device=d2.device)).amax(1)
    return out, overflow, thr, ptie


def permute_rows(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``x[perm]`` for a row permutation (forward only)."""
    return x[perm]
