"""Offline capacity calibration (port of ``d3feat_tpu.data.calibrate``): the
static analogue of the reference's per-run neighbourhood calibration
(reference: datasets/dataloader.py:191-223, keep_ratio 0.8).

Per level, over sample batches:

* neighbour cap = the ``keep_ratio`` quantile (``method="higher"``) of the
  per-query counts of same-cloud points within the level's conv radius
  (``ops.neighbors.count_in_radius``), at least 1;
* point capacity = the largest stacked point count seen, times
  ``headroom``, rounded up to a multiple of 256;
* correspondence capacity = ``config.num_node``.

Levels come from ``ops.subsample.voxel_subsample`` at each level's voxel,
dividing by the voxel size as the reference's calibration does. The counts
run on the card by default (``device="cpu"`` for the CPU); the quantiles on
the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.config import PyramidCaps
from d3feat_tpu_torch.ops.neighbors import count_in_radius
from d3feat_tpu_torch.ops.subsample import lengths_to_mask, voxel_subsample


def _round_up(n: int, multiple: int = 256) -> int:
    return int(-(-n // multiple) * multiple)


def calibrate_caps(sample_pairs: Sequence[dict], config, *, keep_ratio: float = 0.8,
                   headroom: float = 1.15, num_clouds: int = 2,
                   device="cuda") -> PyramidCaps:
    """Static pyramid capacities from sample batches: dicts with ``points``
    [C, 3] (shadow-padded) and ``lengths`` [num_clouds], e.g. packed
    training pairs (numpy arrays or tensors)."""
    dev = resolve_device(device)
    L = config.num_layers
    r0 = config.first_subsampling_dl * config.conv_radius
    hist_counts = [[] for _ in range(L)]
    max_points = [0] * L
    for batch in sample_pairs:
        pts = torch.as_tensor(np.asarray(batch["points"], np.float32), device=dev)
        lens = torch.as_tensor(np.asarray(batch["lengths"], np.int32), device=dev)
        cap = pts.shape[0]
        for l in range(L):
            r = r0 * (2.0**l)
            max_points[l] = max(max_points[l], int(lens.sum()))
            counts = count_in_radius(pts, pts, lens, lens, r, num_clouds=num_clouds,
                                     query_tile=min(1024, cap))
            mask = lengths_to_mask(lens, cap)
            hist_counts[l].append(counts[mask].cpu().numpy())
            if l + 1 < L:
                sub = voxel_subsample(pts, lens, 2.0 * r / config.conv_radius,
                                      out_capacity=cap, num_clouds=num_clouds, divide=True)
                pts, lens = sub.points, sub.lengths
    neighbor_caps, point_caps = [], []
    for l in range(L):
        counts = np.concatenate(hist_counts[l])
        neighbor_caps.append(max(int(np.quantile(counts, keep_ratio, method="higher")), 1))
        point_caps.append(_round_up(int(max_points[l] * headroom)))
    return PyramidCaps(points=tuple(point_caps), neighbors=tuple(neighbor_caps),
                       corr=int(config.num_node))
