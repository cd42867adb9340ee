"""3DMatch host preprocessing (port of ``d3feat_tpu.data.threedmatch``):
``voxel_downsample``, which the scan generator (``data/synthetic.py``)
uses, and the test set (``ThreeDMatchTestset``, the 8 standard scenes).
The training dataset (``ThreeDMatchPairDataset``) is not ported yet.

Test data layout (reference: datasets/ThreeDMatch.py:171-191):
  <root>/fragments/<scene>/*.ply
"""

from __future__ import annotations

import os
import re
from os.path import join
from typing import List, Sequence

import numpy as np

from d3feat_tpu_torch.data.ply import read_ply_points

TEST_SCENES = (
    "7-scenes-redkitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30",
    "sun3d-hotel_uc-scan3",
    "sun3d-hotel_umd-maryland_hotel1",
    "sun3d-hotel_umd-maryland_hotel3",
    "sun3d-mit_76_studyroom-76-1studyroom2",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
)  # the 8 standard 3DMatch test scenes (reference: ThreeDMatch.py:171-180)



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


def _fragment_id(path: str) -> int:
    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


class ThreeDMatchTestset:
    """Voxel-downsampled test fragments for the 8 standard scenes
    (reference: ThreeDMatch.py:154-206)."""

    def __init__(self, root: str, downsample: float = 0.03,
                 scenes: Sequence[str] = TEST_SCENES):
        self.root = root
        self.downsample = downsample
        self.scene_list = list(scenes)
        self.fragment_paths: List[str] = []
        self.scene_of: List[str] = []
        for scene in self.scene_list:
            d = join(root, "fragments", scene)
            plys = sorted(
                (p for p in os.listdir(d) if p.endswith(".ply")),
                key=_fragment_id,
            )
            for p in plys:
                self.fragment_paths.append(join(d, p))
                self.scene_of.append(scene)

    def __len__(self) -> int:
        return len(self.fragment_paths)

    def get_fragment(self, index: int) -> np.ndarray:
        pts = read_ply_points(self.fragment_paths[index])
        return voxel_downsample(np.asarray(pts, np.float64), self.downsample)

    def num_fragments(self, scene: str) -> int:
        return sum(1 for s in self.scene_of if s == scene)
