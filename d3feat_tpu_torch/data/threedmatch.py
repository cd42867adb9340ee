"""3DMatch host preprocessing (port of ``d3feat_tpu.data.threedmatch``,
copied as it is): ``voxel_downsample``, which the scan generator
(``data/synthetic.py``) uses, the training pairs
(``ThreeDMatchPairDataset``) and the test set (``ThreeDMatchTestset``, the
8 standard scenes).

Training data layout (identical to the reference, ThreeDMatch.py:69-79;
``data/prepare.py`` writes it from fragment PLYs and gt logs):
  <root>/3DMatch_{split}_{downsample:.3f}_points.pkl   id -> [N,3] float
  <root>/3DMatch_{split}_{downsample:.3f}_keypts.pkl   "src@tgt" -> [M,2] int
Test data layout (reference: datasets/ThreeDMatch.py:171-191):
  <root>/fragments/<scene>/*.ply

Pair selection, augmentation, correspondence subsampling and the
anchor-keypoint distance matrix follow ThreeDMatch.py:93-147; the >50k
resample guard generalizes to "the pair must fit the level-0 capacity".
"""

from __future__ import annotations

import os
import pickle
import re
from os.path import exists, join
from typing import Dict, List, Sequence

import numpy as np

from d3feat_tpu_torch.data.augment import augment_pair
from d3feat_tpu_torch.data.pack import PackedPair, pack_pair
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


class ThreeDMatchPairDataset:
    """Training/validation fragment pairs with ground-truth correspondences."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        num_node: int = 128,
        downsample: float = 0.03,
        self_augment: bool = False,
        augment_noise: float = 0.005,
        augment_axis: int = 1,
        augment_rotation: float = 1.0,
        augment_translation: float = 0.5,
        max_points: int = 50000,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.num_node = num_node
        self.downsample = downsample
        self.self_augment = self_augment
        self.augment_noise = augment_noise
        self.augment_axis = augment_axis
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        self.max_points = max_points
        self.rng = np.random.default_rng(seed)

        pts_file = join(root, f"3DMatch_{split}_{downsample:.3f}_points.pkl")
        keypts_file = join(root, f"3DMatch_{split}_{downsample:.3f}_keypts.pkl")
        if not (exists(pts_file) and exists(keypts_file)):
            raise FileNotFoundError(
                f"3DMatch pickles not found under {root!r}: {pts_file}"
            )
        with open(pts_file, "rb") as f:
            data = pickle.load(f)
            self.points: List[np.ndarray] = [*data.values()]
            self.ids_list: List[str] = [*data.keys()]
        with open(keypts_file, "rb") as f:
            self.correspondences: Dict[str, np.ndarray] = pickle.load(f)

        self.index_of = {i: n for n, i in enumerate(self.ids_list)}
        self.src_to_tgt: Dict[str, List[str]] = {}
        for idpair in self.correspondences:
            src, tgt = idpair.split("@")
            self.src_to_tgt.setdefault(src, []).append(tgt)
        self.src_ids = list(self.src_to_tgt.keys())

    def __len__(self) -> int:
        return len(self.src_ids)

    def get_pair(self, index: int):
        """(pts0, pts1, feat0, feat1, corr, dist_keypts) for one sample,
        with augmentation applied (reference: ThreeDMatch.py:93-147)."""
        src_id = self.src_ids[index]
        # 50% first target / 50% random target (ThreeDMatch.py:96-99)
        tgts = self.src_to_tgt[src_id]
        tgt_id = tgts[0] if self.rng.random() > 0.5 else tgts[self.rng.integers(len(tgts))]

        src_points = self.points[self.index_of[src_id]]
        if self.self_augment:
            tgt_points = src_points
            n = len(src_points)
            corr = np.stack([np.arange(n), np.arange(n)], axis=1)
        else:
            tgt_points = self.points[self.index_of[tgt_id]]
            corr = self.correspondences[f"{src_id}@{tgt_id}"]

        if len(src_points) > self.max_points or len(tgt_points) > self.max_points:
            # resample another pair (ThreeDMatch.py:114-115)
            return self.get_pair(int(self.rng.integers(len(self))))

        pts0, pts1, _ = augment_pair(
            self.rng, np.asarray(src_points, np.float64),
            np.asarray(tgt_points, np.float64),
            augment_noise=self.augment_noise, augment_axis=self.augment_axis,
            augment_rotation=self.augment_rotation,
            augment_translation=self.augment_translation,
        )

        if len(corr) > self.num_node:
            sel = self.rng.choice(len(corr), self.num_node, replace=False)
            corr = corr[sel]
        corr = np.asarray(corr, np.int32)

        kp = pts0[corr[:, 0]]
        dist_keypts = np.linalg.norm(
            kp[:, None] - kp[None], axis=-1
        ).astype(np.float32)

        feat0 = np.ones((len(pts0), 1), np.float32)
        feat1 = np.ones((len(pts1), 1), np.float32)
        if self.self_augment:
            # zero 99% of input features (ThreeDMatch.py:145-147)
            z0 = self.rng.choice(len(pts0), int(len(pts0) * 0.99), replace=False)
            z1 = self.rng.choice(len(pts1), int(len(pts1) * 0.99), replace=False)
            feat0[z0] = 0.0
            feat1[z1] = 0.0
        return pts0, pts1, feat0, feat1, corr, dist_keypts

    def packed(self, index: int, *, point_capacity: int,
               corr_capacity: int) -> PackedPair:
        pts0, pts1, feat0, feat1, corr, dk = self.get_pair(index)
        if len(pts0) + len(pts1) > point_capacity:
            return self.packed(
                int(self.rng.integers(len(self))),
                point_capacity=point_capacity, corr_capacity=corr_capacity,
            )
        return pack_pair(
            pts0, pts1, feat0, feat1, corr, dk,
            point_capacity=point_capacity, corr_capacity=corr_capacity,
        )


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
