"""On-device multi-scale pyramid construction (port of the band path of
``d3feat_tpu.ops.pyramid``).

Radius schedule: r_0 = first_subsampling_dl * conv_radius, doubling per
level; the voxel from level l to l + 1 is 2 r_l / conv_radius; pool
neighbors at r_l, nearest-upsample at 2 r_l.

Everything is in sorted space: each level's points and its conv, pool and
upsample lists are in the level's key-sorted row order, and list values are
sorted-support positions (shadow = the support level's capacity). ``band``
holds each level's sorted state for the band kernels, ``sel_thr`` the
per-query selection thresholds of every conv and pool search.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from d3feat_tpu_torch.ops.neighbors import (
    SortedLevel,
    make_level_frame,
    radius_neighbors_sorted,
)
from d3feat_tpu_torch.ops.subsample import lengths_to_mask, voxel_subsample


@dataclass(frozen=True)
class PyramidSpec:
    """Static description of the pyramid."""

    num_levels: int
    first_subsampling_dl: float
    conv_radius: float
    point_caps: Tuple[int, ...]      # [L] per-level point capacity
    neighbor_caps: Tuple[int, ...]   # [L] per-level neighbor width
    conv_r_scale: Tuple[float, ...]  # [L] 1.0 or deform_radius/conv_radius
    pool_r_scale: Tuple[float, ...]  # [L] same, for strided blocks
    num_clouds: int = 2
    band_frac: float = 0.1           # band margin ~ 2*frac*rows/clouds

    @property
    def radii(self) -> Tuple[float, ...]:
        r0 = self.first_subsampling_dl * self.conv_radius
        return tuple(r0 * (2.0**l) for l in range(self.num_levels))


def _round_up_256(n: int) -> int:
    return -(-n // 256) * 256


def level_band_cap(rows: int, num_clouds: int, band_frac: float,
                   tile: int = 128, ratio: int = 1) -> int:
    """Static band width for a support level (shared by the select and the
    band kernels so their windows coincide). ``ratio`` = ceil(support
    capacity / query capacity): strided (pool) searches get a 4x density
    allowance; every cap has a 2048-row floor and at most the whole level."""
    eff = 1 if ratio <= 1 else 4 * ratio
    return min(rows, max(2048, _round_up_256(
        tile * eff + int(2 * band_frac * rows / num_clouds)
    )))


def make_pyramid_spec(config, num_clouds: int = 2) -> PyramidSpec:
    """Derive the static pyramid spec from a config + its architecture list
    (walks the block list like the reference collate to decide, per level,
    whether the conv and pool searches use the deformable radius)."""
    arch = config.architecture()
    deform_scale = config.deform_radius / config.conv_radius
    conv_scale: List[float] = []
    pool_scale: List[float] = []
    layer_blocks: List[str] = []
    for block_i, block in enumerate(arch):
        if "global" in block or "upsample" in block:
            break
        if not ("pool" in block or "strided" in block):
            layer_blocks.append(block)
            if block_i < len(arch) - 1 and "upsample" not in arch[block_i + 1]:
                continue
        if layer_blocks and any("deformable" in b for b in layer_blocks[:-1]):
            conv_scale.append(deform_scale)
        else:
            conv_scale.append(1.0)
        if "pool" in block or "strided" in block:
            pool_scale.append(deform_scale if "deformable" in block else 1.0)
        layer_blocks = []
    num_levels = len(conv_scale)
    caps = config.caps
    if caps.num_levels < num_levels:
        raise ValueError(
            f"caps define {caps.num_levels} levels but architecture needs {num_levels}")
    return PyramidSpec(
        num_levels=num_levels,
        first_subsampling_dl=config.first_subsampling_dl,
        conv_radius=config.conv_radius,
        point_caps=tuple(caps.points[:num_levels]),
        neighbor_caps=tuple(caps.neighbors[:num_levels]),
        conv_r_scale=tuple(conv_scale),
        pool_r_scale=tuple(pool_scale) + (1.0,) * (num_levels - len(pool_scale)),
        num_clouds=num_clouds,
        band_frac=config.band_frac,
    )


def level_band_pad(spec: PyramidSpec, l: int, rows: int) -> int:
    """Padding rows of level ``l``'s sorted supports: room for the widest
    search reading the level, its conv search (tile 256) or the pool search
    from level l + 1 (tile 128, density ratio)."""
    B, L = spec.num_clouds, spec.num_levels
    ratio = -(-spec.point_caps[l] // spec.point_caps[l + 1]) if l + 1 < L else 1
    return max(level_band_cap(rows, B, spec.band_frac, tile=256, ratio=1),
               level_band_cap(rows, B, spec.band_frac, tile=128, ratio=ratio))


def level_search(q_lv: SortedLevel, s_lv: SortedLevel, radius: float, max_k: int,
                 spec: PyramidSpec, impl: str = "auto"):
    """One conv (q = s level), pool (q = the coarser level) or upsample
    (``max_k`` 1) search of the pyramid: ``(lists, overflow)`` plus, for
    ``max_k > 1``, the ``(thr, ptie)`` selection thresholds."""
    ratio = -(-s_lv.n // q_lv.n)  # > 1 only for pool searches
    qt = 128 if (ratio > 1 or s_lv.n < 256) else 256
    return radius_neighbors_sorted(
        q_lv, s_lv, radius, max_k=max_k, query_tile=qt,
        band_cap=level_band_cap(s_lv.n, spec.num_clouds, spec.band_frac, tile=qt,
                                ratio=ratio),
        with_threshold=max_k > 1, impl=impl)


def build_pyramid(points: torch.Tensor, lengths: torch.Tensor, *, spec: PyramidSpec,
                  impl: str = "auto") -> Dict:
    """Build the full sorted-space multi-scale structure for one stacked
    batch.

    ``points`` [C0, 3] stacked contiguous clouds padded to
    ``spec.point_caps[0]``, ``lengths`` [num_clouds] int32. Returns a dict
    of per-level lists ``points``, ``neighbors``, ``pools``, ``upsamples``,
    ``lengths``, ``masks``; ``band`` {level: sorted state}; ``sel_thr``
    {search name: (thr, ptie)}; ``overflow`` (any capacity exceeded) and
    ``overflow_by`` {source: flag}. ``impl`` selects the K1 implementation
    (see ``ops.select.band_select``).
    """
    if points.shape[0] != spec.point_caps[0]:
        raise ValueError(f"points capacity {points.shape[0]} != spec {spec.point_caps[0]}")
    L = spec.num_levels
    B = spec.num_clouds
    r0 = spec.first_subsampling_dl * spec.conv_radius
    out: Dict = {"points": [], "neighbors": [], "pools": [], "upsamples": [],
                 "lengths": [], "masks": [], "band": {}, "sel_thr": {}}
    pts, lens = points.float(), lengths.to(torch.int32)
    overflow = torch.zeros((), dtype=torch.bool, device=points.device)
    overflow_by = {}
    frame_axis, frame_origin = make_level_frame(pts, lens, B)

    def level(l: int, p, ln) -> SortedLevel:
        return SortedLevel(p, ln, B, frame_axis, frame_origin,
                           band_pad=level_band_pad(spec, l, p.shape[0]))

    def search(q_lv, s_lv, r, k, name):
        nonlocal overflow
        res = level_search(q_lv, s_lv, r, k, spec, impl)
        if k > 1:  # conv/pool searches feed the band kernels
            out["sel_thr"][name] = (res[2], res[3])
        overflow = overflow | res[1]
        overflow_by[name] = res[1]
        return res[0]

    lv = level(0, pts, lens)
    for l in range(L):
        r = r0 * (2.0**l)
        out["points"].append(lv.pts_sorted)
        out["lengths"].append(lens)
        out["masks"].append(lengths_to_mask(lens, pts.shape[0]))
        out["band"][l] = {"key_sorted": lv.key_sorted, "order": lv.order, "inv": lv.inv,
                          "q_rows": lv.q_rows, "s_rows": lv.s_rows}
        out["neighbors"].append(
            search(lv, lv, r * spec.conv_r_scale[l], spec.neighbor_caps[l], f"conv{l}"))
        if l + 1 < L:
            sub = voxel_subsample(
                pts, lens, 2.0 * r / spec.conv_radius,
                out_capacity=spec.point_caps[l + 1], num_clouds=B,
                # level 0's spacing comes from the host downsample (plus
                # noise), not from a previous level: double margin
                occupancy_cap=64 if l == 0 else 32)
            overflow = overflow | sub.overflow
            overflow_by[f"sub{l}"] = sub.overflow
            sub_lv = level(l + 1, sub.points, sub.lengths)
            out["pools"].append(search(sub_lv, lv, r * spec.pool_r_scale[l],
                                       spec.neighbor_caps[l], f"pool{l}"))
            out["upsamples"].append(search(lv, sub_lv, 2.0 * r, 1, f"up{l}"))
            pts, lens, lv = sub.points, sub.lengths, sub_lv
    out["overflow"] = overflow
    out["overflow_by"] = overflow_by
    return out
