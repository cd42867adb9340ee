"""3DMatch host preprocessing (port of ``d3feat_tpu.data.threedmatch``):
for now only ``voxel_downsample``, which the scan generator
(``data/synthetic.py``) uses. The datasets that read the 3DMatch download
are not ported yet.
"""

from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Voxel-grid barycenter downsampling (host numpy).

    Matches the reference preprocessing semantics: one output point per
    occupied voxel, at the mean of the voxel's points (open3d
    voxel_down_sample / grid_subsampling.cpp:87). Output is ordered by
    voxel key (deterministic).
    """
    if len(points) == 0:
        return points.astype(np.float32)
    origin = np.floor(points.min(axis=0) / voxel_size) * voxel_size
    cell = np.floor((points - origin) / voxel_size).astype(np.int64)
    span = cell.max(axis=0) + 1
    key = (cell[:, 2] * span[1] + cell[:, 1]) * span[0] + cell[:, 0]
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pts_s = points[order]
    first = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    seg = np.cumsum(first) - 1
    n_vox = seg[-1] + 1
    sums = np.zeros((n_vox, 3), np.float64)
    np.add.at(sums, seg, pts_s)
    cnts = np.bincount(seg, minlength=n_vox)[:, None]
    return (sums / cnts).astype(np.float32)
