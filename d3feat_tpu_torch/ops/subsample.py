"""On-device voxel-grid barycenter subsampling (port of
``d3feat_tpu.ops.subsample``).

Every point is binned into a voxel of side ``voxel_size`` anchored at
``floor(min_corner / dl) * dl`` per cloud; each occupied voxel emits the
barycenter of its points. Output has a fixed capacity, is sorted by
(cloud, z, y, x) voxel, and pads with shadow rows at ``SHADOW_COORD``.

The sums use the reference's segmented doubling prefix over the sorted rows
in the same order, so only the order of points inside one voxel (the JAX
sort is unstable, this one is stable) can move a barycenter, by ulps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SHADOW_COORD = 1.0e6
_MAX_CELLS = 1 << 16  # per-axis voxel-grid bound (16 bits per axis in sort keys)
_INVALID_KEY = (1 << 63) - 1


class SubsampleResult(NamedTuple):
    points: torch.Tensor    # [C, 3] float32, shadow-padded
    lengths: torch.Tensor   # [B] int32
    valid: torch.Tensor     # [C] bool
    overflow: torch.Tensor  # [] bool: too many voxels, or a run longer than the window


def lengths_to_cloud_ids(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[N] int32 cloud id per row of the contiguous stacked layout; padding -> B."""
    cum = torch.cumsum(lengths.to(torch.int64), 0)
    idx = torch.arange(n, device=lengths.device)
    return (idx[:, None] >= cum[None, :]).sum(1).to(torch.int32)


def lengths_to_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """[N] bool validity mask for the contiguous stacked layout."""
    return torch.arange(n, device=lengths.device) < lengths.to(torch.int64).sum()


def voxel_subsample(points: torch.Tensor, lengths: torch.Tensor, voxel_size: float,
                    *, out_capacity: int, num_clouds: int,
                    occupancy_cap: int = 64) -> SubsampleResult:
    """Barycenter voxel subsampling of a stacked, contiguous batch of clouds.

    ``points`` [N, 3] float32 (rows beyond ``sum(lengths)`` are padding),
    ``lengths`` [num_clouds] int32. Returns barycenters sorted by
    (cloud, voxel z, y, x), contiguous per cloud, padded to ``out_capacity``.
    """
    n = points.shape[0]
    b = num_clouds
    dev = points.device
    dl = torch.tensor(float(voxel_size), dtype=torch.float32, device=dev)

    cid = lengths_to_cloud_ids(lengths, n)
    valid = cid < b
    big = torch.tensor(SHADOW_COORD, dtype=torch.float32, device=dev)
    mins = torch.stack([
        torch.where((cid == c)[:, None], points, big).amin(0) for c in range(b)
    ])
    cid_c = torch.clamp(cid, max=b - 1).long()
    origin = torch.floor(mins / dl) * dl

    rel = (points - origin[cid_c]) / dl
    cell = torch.clamp(torch.floor(rel).to(torch.int32), 0, _MAX_CELLS - 1).long()

    # one int64 key = (cloud, z) high word, (y, x) low word; invalid last
    k_lo = cell[:, 0] | (cell[:, 1] << 16)
    k_hi = cell[:, 2] | (cid.long() << 16)
    key = torch.where(valid, (k_hi << 32) | k_lo,
                      torch.full_like(k_lo, _INVALID_KEY))
    key_s, order = torch.sort(key, stable=True)
    s_pts = points[order]
    s_valid = key_s != _INVALID_KEY
    s_cid = torch.where(s_valid, key_s >> 48, torch.full_like(key_s, b))

    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1  # run id, ascending

    # segmented inclusive prefix (Hillis-Steele doubling): each run's total
    # lands in its LAST row after ceil(log2(window)) shifted masked adds
    c = out_capacity
    run_ids = torch.arange(c, device=dev)
    steps = max(1, (occupancy_cap - 1).bit_length())
    window = 1 << steps
    vals = torch.cat([s_pts.float(), torch.ones(n, 1, device=dev)], 1)
    for sft in (1 << t for t in range(steps)):
        if sft >= n:
            break
        same = seg[sft:] == seg[:-sft]
        shifted = torch.where(same[:, None], vals[:-sft], 0.0)
        vals = torch.cat([vals[:sft], vals[sft:] + shifted])

    ends = torch.searchsorted(seg, run_ids, right=True)  # count(seg <= id)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    last = torch.clamp(ends - 1, min=0)
    sums = vals[last, :3]
    cnts = (ends - starts).to(torch.float32)
    seg_cid = s_cid[last]

    n_unique = (is_first & s_valid).sum()
    out_slot_valid = run_ids < torch.clamp(n_unique, max=c)
    occ_overflow = torch.where(out_slot_valid, ends - starts, 0).max() > window
    bary = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_points = torch.where(out_slot_valid[:, None], bary, big)
    out_cid = torch.where(out_slot_valid, seg_cid, torch.full_like(seg_cid, b))
    out_lengths = torch.stack([(out_cid == c_).sum() for c_ in range(b)])
    return SubsampleResult(
        points=out_points.float(),
        lengths=out_lengths.to(torch.int32),
        valid=out_slot_valid,
        overflow=(n_unique > c) | occ_overflow,
    )
