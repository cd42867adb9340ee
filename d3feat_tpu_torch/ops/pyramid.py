"""On-device multi-scale pyramid construction (port of
``d3feat_tpu.ops.pyramid``).

Radius schedule: r_0 = first_subsampling_dl * conv_radius, doubling per
level; the voxel from level l to l + 1 is 2 r_l / conv_radius; pool
neighbors at r_l, nearest-upsample at 2 r_l.

Two routes, chosen by ``PyramidSpec.search`` (the config's
``neighbor_search``). ``'pallas'`` is the band route, the JAX package's TPU
route: everything is in sorted space (below). ``'banded'``, ``'brute'``
and ``'grid'`` take the original-order route, the JAX package's XLA route:
levels keep the subsampler's row order, lists hold original support
indices (shadow = the support level's capacity), every search is the
original-order search of ``ops.neighbors`` that the reference picks for
it, and ``band`` and ``sel_thr`` are empty, so every KPConv runs the gather
KPConv and the head the gather head.

On the band route everything is in sorted space: each level's points and
its conv, pool and upsample lists are in the level's key-sorted row order,
and list values are sorted-support positions (shadow = the support level's capacity). ``band``
holds each level's sorted state for the band kernels, ``sel_thr`` the
per-query selection thresholds of every conv and pool search.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from d3feat_tpu_torch.ops.build import uses_kernel
from d3feat_tpu_torch.ops.neighbors import (
    SortedLevel,
    frame_dirs,
    make_level_frame,
    radius_neighbors,
    radius_neighbors_banded,
    radius_neighbors_grid,
    radius_neighbors_sorted,
)
from d3feat_tpu_torch.ops.select import band_select
from d3feat_tpu_torch.ops.subsample import lengths_to_mask, voxel_subsample
from d3feat_tpu_torch.utils.profiling import span


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
    query_tile: int = 1024           # query tile of the original-order searches
    search: str = "pallas"           # 'pallas' (band route) | 'banded' | 'brute' | 'grid'
    band_frac: float = 0.1           # band margin ~ 2*frac*rows/clouds
    cell_capacity: int = 32          # candidates kept per grid cell ('grid')

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
        query_tile=config.query_tile,
        search=config.neighbor_search,
        band_frac=config.band_frac,
        cell_capacity=config.cell_capacity,
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


SEARCHES = ("pallas", "banded", "brute", "grid")


def original_search(q, s, ql, sl, r: float, k: int, spec: PyramidSpec):
    """One search of the original-order route, as the JAX package's
    ``build_pyramid`` picks it off the TPU (``d3feat_tpu/ops/pyramid.py``,
    ``search``): the banded search for supports above 4096 rows under
    ``'banded'``, the grid search under ``'grid'``, the brute search
    otherwise. The query tile shrinks with the density ratio for pool
    searches. Returns (lists, overflow or None)."""
    B = spec.num_clouds
    ratio = -(-s.shape[0] // q.shape[0])
    tile = min(spec.query_tile, q.shape[0])
    if s.shape[0] > q.shape[0]:
        tile = max(128, (tile * q.shape[0]) // s.shape[0])
    if spec.search == "banded" and s.shape[0] > 4096:
        band = level_band_cap(s.shape[0], B, spec.band_frac, tile=tile, ratio=ratio)
        return radius_neighbors_banded(q, s, ql, sl, r, max_k=k, num_clouds=B,
                                       query_tile=tile, band_cap=band)
    if spec.search == "grid":
        return radius_neighbors_grid(q, s, ql, sl, r, max_k=k, num_clouds=B, query_tile=tile,
                                     cell_capacity=spec.cell_capacity)
    return radius_neighbors(q, s, ql, sl, r, max_k=k, num_clouds=B, query_tile=tile), None


def build_pyramid(points: torch.Tensor, lengths: torch.Tensor, *, spec: PyramidSpec,
                  impl: str = "auto") -> Dict:
    """Build the full multi-scale structure for one stacked batch, on the
    route of ``spec.search`` (module docstring).

    ``points`` [C0, 3] stacked contiguous clouds padded to
    ``spec.point_caps[0]``, ``lengths`` [num_clouds] int32. Returns a dict
    of per-level lists ``points``, ``neighbors``, ``pools``, ``upsamples``,
    ``lengths``, ``masks``; ``band`` {level: sorted state}; ``sel_thr``
    {search name: (thr, ptie)}; ``overflow`` (any capacity exceeded) and
    ``overflow_by`` {source: flag}. ``impl`` selects the K1 implementation
    (see ``ops.select.band_select``); the original-order route runs no
    kernel.

    The band route with K1's kernel on the card waits on the device
    nowhere and every shape in it follows from ``spec``, so there it is
    built by replaying a CUDA graph captured once per spec and device
    (``PyramidGraph``): the result is the eager build's, bit for bit, in
    tensors of its own. Every other route, and a call inside another
    capture, builds eagerly.
    """
    with span("pyramid"):
        if (points.is_cuda and lengths.device == points.device and spec.search == "pallas"
                and uses_kernel(impl, points) and not torch.cuda.is_current_stream_capturing()):
            return _graph(points, lengths, spec, impl).replay(points, lengths)
        return _build_pyramid(points, lengths, spec, impl)


build_pyramid.launches_captured = 0  # graphs captured
build_pyramid.launches_replayed = 0  # pyramids built by a replay

GRAPHS = 8  # graphs kept, the least recently used dropped first
_graphs: "OrderedDict[tuple, PyramidGraph]" = OrderedDict()


def _graph(points, lengths, spec: PyramidSpec, impl: str) -> "PyramidGraph":
    key = (spec, points.device)
    g = _graphs.get(key)
    if g is None:
        g = _graphs[key] = PyramidGraph(points, lengths, spec, impl)
        while len(_graphs) > GRAPHS:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    return g


def _clone(x):
    """``x`` with every tensor in it (nested in lists, tuples and dicts)
    copied."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


class PyramidGraph:
    """The band-route pyramid of one spec on one device as a CUDA graph:
    captured from the eager build on static input buffers (float32 points,
    int32 lengths) after one eager build warms the path on a side stream
    (the kernels' libraries loaded, the constants on the device), in a
    private memory pool. K1's launches inside it count on
    ``band_select.launches`` at every replay."""

    def __init__(self, points, lengths, spec: PyramidSpec, impl: str):
        with span("pyramid.capture"), torch.cuda.device(points.device):
            self.points = points.float().clone()
            self.lengths = lengths.to(torch.int32).clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _build_pyramid(self.points, self.lengths, spec, impl)
            torch.cuda.current_stream().wait_stream(side)
            self.dirs = frame_dirs(points.device)  # read by the graph: held for its life
            self.graph = torch.cuda.CUDAGraph()
            k1 = band_select.launches
            with torch.cuda.graph(self.graph):
                self.out = _build_pyramid(self.points, self.lengths, spec, impl)
            # K1's launches recorded into the graph run at each replay
            self.k1, band_select.launches = band_select.launches - k1, k1
        build_pyramid.launches_captured += 1

    def replay(self, points, lengths) -> Dict:
        """The pyramid of ``points`` and ``lengths``, in new tensors: the
        graph's own outputs are overwritten by its next replay."""
        with span("pyramid.replay"):
            self.points.copy_(points)
            self.lengths.copy_(lengths)
            self.graph.replay()
            band_select.launches += self.k1
            build_pyramid.launches_replayed += 1
            return _clone(self.out)


def _build_pyramid(points, lengths, spec: PyramidSpec, impl: str) -> Dict:
    if points.shape[0] != spec.point_caps[0]:
        raise ValueError(f"points capacity {points.shape[0]} != spec {spec.point_caps[0]}")
    if spec.search not in SEARCHES:
        raise ValueError(f"neighbor_search {spec.search!r} is not one of {SEARCHES}")
    band_route = spec.search == "pallas"
    L = spec.num_levels
    B = spec.num_clouds
    r0 = spec.first_subsampling_dl * spec.conv_radius
    out: Dict = {"points": [], "neighbors": [], "pools": [], "upsamples": [],
                 "lengths": [], "masks": [], "band": {}, "sel_thr": {}}
    pts, lens = points.float(), lengths.to(torch.int32)
    overflow = torch.zeros((), dtype=torch.bool, device=points.device)
    overflow_by = {}
    if band_route:
        with span("pyramid.frame"):
            frame_axis, frame_origin = make_level_frame(pts, lens, B)
    levels: Dict[int, SortedLevel] = {}

    def level(l: int, p, ln) -> SortedLevel:
        """The band route's sorted state of level ``l``, built once."""
        if l not in levels:
            with span("pyramid.level", l):
                levels[l] = SortedLevel(p, ln, B, frame_axis, frame_origin,
                                        band_pad=level_band_pad(spec, l, p.shape[0]))
        return levels[l]

    def search(q, s, ql, sl, r, k, q_level, s_level, name):
        nonlocal overflow
        if band_route:
            q_lv, s_lv = level(q_level, q, ql), level(s_level, s, sl)
            with span("pyramid.search", name):
                res = level_search(q_lv, s_lv, r, k, spec, impl)
            if k > 1:  # conv/pool searches feed the band kernels
                out["sel_thr"][name] = (res[2], res[3])
            idx, ov = res[0], res[1]
        else:
            with span("pyramid.search", name):
                idx, ov = original_search(q, s, ql, sl, r, k, spec)
        if ov is not None:
            overflow = overflow | ov
            overflow_by[name] = ov
        return idx

    for l in range(L):
        r = r0 * (2.0**l)
        if band_route:
            lv = level(l, pts, lens)
            out["points"].append(lv.pts_sorted)
            out["band"][l] = {"key_sorted": lv.key_sorted, "order": lv.order, "inv": lv.inv,
                              "q_rows": lv.q_rows, "s_rows": lv.s_rows}
        else:
            out["points"].append(pts)
        out["lengths"].append(lens)
        out["masks"].append(lengths_to_mask(lens, pts.shape[0]))
        out["neighbors"].append(search(pts, pts, lens, lens, r * spec.conv_r_scale[l],
                                       spec.neighbor_caps[l], l, l, f"conv{l}"))
        if l + 1 < L:
            with span("pyramid.subsample", l):
                sub = voxel_subsample(
                    pts, lens, 2.0 * r / spec.conv_radius,
                    out_capacity=spec.point_caps[l + 1], num_clouds=B,
                    # level 0's spacing comes from the host downsample (plus
                    # noise), not from a previous level: double margin
                    occupancy_cap=64 if l == 0 else 32)
            overflow = overflow | sub.overflow
            overflow_by[f"sub{l}"] = sub.overflow
            out["pools"].append(search(sub.points, pts, sub.lengths, lens,
                                       r * spec.pool_r_scale[l], spec.neighbor_caps[l],
                                       l + 1, l, f"pool{l}"))
            out["upsamples"].append(search(pts, sub.points, lens, sub.lengths, 2.0 * r, 1,
                                           l, l + 1, f"up{l}"))
            pts, lens = sub.points, sub.lengths
    out["overflow"] = overflow
    out["overflow_by"] = overflow_by
    return out
