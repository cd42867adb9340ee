"""Voxel subsampling and radius search of the reference, and the stage-by-
stage check of a pyramid against them.

The voxel grid is the configuration's: per cloud, origin ``floor(min *
(1 / dl)) * dl`` and cell ``floor((p - origin) * (1 / dl))``, each an
elementwise float32 operation, so that a point on a voxel plane falls in
the same voxel as the grid defines it. A barycentre is the float64 mean of
its voxel's points, rounded to float32. Distances are float64.

A list passes when it is a set of the ``k`` nearest supports of the query's
own cloud within the radius, where a support whose squared distance lies
within ``TIE`` (relative) of the radius or of the farthest listed one may
be in or out: float32 distances differ from float64 ones by a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

TIE = 1e-6          # relative band of squared distance inside which a support may go either way
POINT_TOL = 1e-5    # metres between a program's barycentre and the reference's
SHADOW = 1.0e6
_BLOCK = 4096


def offsets(lengths) -> list:
    """Row offsets of the contiguous clouds of ``lengths`` (a list of ints)."""
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


def voxel_grid(points: torch.Tensor, voxel: float):
    """(origin [3], cells [N, 3] int64) of one cloud's float32 points."""
    dl = torch.tensor(float(voxel), dtype=torch.float32, device=points.device)
    inv = torch.tensor(1.0, dtype=torch.float32, device=points.device) / dl
    origin = torch.floor(points.amin(0) * inv) * dl
    cells = torch.clamp(torch.floor((points - origin) * inv).to(torch.int32), 0, 65535).long()
    return origin, cells


def voxel_barycentres(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """[M, 3] float32 barycentres of the occupied voxels of one cloud."""
    if points.shape[0] == 0:
        return points.new_zeros((0, 3))
    _, cells = voxel_grid(points, voxel)
    key = cells[:, 0] | (cells[:, 1] << 16) | (cells[:, 2] << 32)
    uniq, inverse = torch.unique(key, return_inverse=True)
    sums = torch.zeros((len(uniq), 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, inverse, points.double())
    counts = torch.bincount(inverse, minlength=len(uniq)).double()
    return (sums / counts[:, None]).float()


def sq_dists(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[nq, ns] float64 squared distances."""
    q, s = q.double(), s.double()
    d2 = (q * q).sum(1)[:, None] + (s * s).sum(1)[None, :] - 2.0 * (q @ s.T)
    return torch.clamp(d2, min=0.0)


def search_misses(q, q_lens, s, s_lens, lists, radius: float, k: int) -> int:
    """Valid query rows of ``q`` whose row of ``lists`` (values index ``s``,
    the shadow is ``len(s)``) is not a set of the ``k`` nearest supports of
    its cloud within ``radius``, near-ties allowed (module docstring)."""
    r = np.float32(radius)
    r2 = float(np.float32(r * r))
    lo, hi = r2 * (1.0 - TIE), r2 * (1.0 + TIE)
    qo, so = offsets(q_lens), offsets(s_lens)
    shadow = s.shape[0]
    bad = 0
    for c in range(len(q_lens)):
        s0, s1 = so[c], so[c + 1]
        sc = s[s0:s1]
        for b0 in range(qo[c], qo[c + 1], _BLOCK):
            b1 = min(b0 + _BLOCK, qo[c + 1])
            rows = lists[b0:b1].long()
            listed = rows != shadow
            foreign = listed & ((rows < s0) | (rows >= s1))
            own = listed & ~foreign
            d2 = sq_dists(q[b0:b1], sc)
            n_listed = listed.sum(1)
            # unlisted entries mark a spare last column
            loc = torch.where(own, rows - s0, d2.shape[1])
            mark = torch.zeros((d2.shape[0], d2.shape[1] + 1), dtype=torch.bool,
                               device=d2.device)
            mark.scatter_(1, loc, True)
            mark = mark[:, :-1]
            dup = mark.sum(1) != own.sum(1)
            d_list = torch.where(own, d2.gather(1, loc.clamp(max=d2.shape[1] - 1)), -1.0)
            outside = (d_list > hi).any(1)
            far = d_list.amax(1)
            full = n_listed >= k
            definite = d2 <= lo
            missing = (~mark) & definite & ((~full)[:, None] | (d2 < far[:, None] * (1.0 - TIE)))
            row_bad = foreign.any(1) | dup | outside | (n_listed > k) | missing.any(1)
            bad += int(row_bad.sum())
    return bad


def nearest_match(a: torch.Tensor, b: torch.Tensor):
    """(index into ``b`` of the nearest point, distance) for each row of ``a``."""
    idx, dist = [], []
    for a0 in range(0, a.shape[0], _BLOCK):
        d2 = sq_dists(a[a0:a0 + _BLOCK], b)
        v, i = d2.min(1)
        idx.append(i)
        dist.append(torch.sqrt(v))
    if not idx:
        return a.new_zeros((0,), dtype=torch.long), a.new_zeros((0,), dtype=torch.float64)
    return torch.cat(idx), torch.cat(dist)


def subsample_misses(prev, prev_lens, level, level_lens, voxel: float) -> int:
    """Barycentres of ``level`` (valid rows, per cloud) that do not match
    the reference's subsampling of ``prev`` one to one within ``POINT_TOL``,
    counting a cloud of the wrong size by the size difference."""
    po, lo_ = offsets(prev_lens), offsets(level_lens)
    bad = 0
    for c in range(len(prev_lens)):
        ref = voxel_barycentres(prev[po[c]:po[c + 1]], voxel)
        got = level[lo_[c]:lo_[c + 1]]
        if len(ref) != len(got):
            bad += abs(len(ref) - len(got)) + 1
            continue
        idx, dist = nearest_match(got, ref)
        once = torch.bincount(idx, minlength=len(ref)) == 1
        bad += int((dist > POINT_TOL).sum()) + int((~once).sum())
    return bad


def pyramid_misses(pyr: dict, points: torch.Tensor, lengths, cfg, spec) -> dict:
    """Stage-by-stage check of a program's pyramid ``pyr`` (host-side lists
    of device tensors: ``points``, ``lengths``, ``neighbors``, ``pools``,
    ``upsamples``, optional ``order``) built from the stacked input
    ``points`` with cloud ``lengths``. Each stage starts from the
    program's previous level, so float32 rounding does not cascade.
    Returns misses by stage: level 0 rows that are not the input's rows,
    subsample voxels, and conv, pool and upsample lists."""
    out = {"level0": 0, "subsample": 0, "conv": 0, "pool": 0, "upsample": 0, "lengths": 0}
    L = len(pyr["points"])
    lens = [[int(v) for v in ln] for ln in pyr["lengths"]]
    n0 = sum(int(v) for v in lengths)
    if lens[0] != [int(v) for v in lengths]:
        out["lengths"] += 1
    order = pyr.get("order")
    p0 = pyr["points"][0][:n0]
    if order is not None:
        perm = order[:n0].long()
        ok = torch.bincount(perm, minlength=n0)[:n0] == 1
        out["level0"] += int((~ok).sum()) + int((perm >= n0).sum())
        same = (pyr["points"][0][:n0] == points[perm.clamp(max=points.shape[0] - 1)]).all(1)
        out["level0"] += int((~same).sum())
    else:
        out["level0"] += int((~(p0 == points[:n0]).all(1)).sum())
    r0 = cfg["first_subsampling_dl"] * cfg["conv_radius"]
    for l in range(L):
        r = r0 * (2.0 ** l)
        pts, ln = pyr["points"][l], lens[l]
        out["conv"] += search_misses(pts, ln, pts, ln, pyr["neighbors"][l],
                                     r * spec["conv_r_scale"][l], spec["neighbor_caps"][l])
        if l + 1 < L:
            nxt, nl = pyr["points"][l + 1], lens[l + 1]
            out["subsample"] += subsample_misses(pts, ln, nxt, nl,
                                                 2.0 * r / cfg["conv_radius"])
            out["pool"] += search_misses(nxt, nl, pts, ln, pyr["pools"][l],
                                         r * spec["pool_r_scale"][l], spec["neighbor_caps"][l])
            out["upsample"] += search_misses(pts, ln, nxt, nl, pyr["upsamples"][l], 2.0 * r, 1)
    return out
