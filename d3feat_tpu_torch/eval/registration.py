"""Geometric-registration evaluation: feature-match recall per scene
(port of ``d3feat_tpu.eval.registration``, host numpy copied as it is).

Counterpart of the reference evaluation driver
(reference: test.py:20-82 ``register_one_scene`` + :215-234 aggregation):
for every fragment pair (i < j) present in the scene's ``gt.log``
(pairs with >30% overlap), select the top-k-score keypoints of each
fragment, build mutual-NN descriptor correspondences, move the target
keypoints by the GT pose, count inliers at ``distance_threshold`` (10 cm),
and call the pair matched when the inlier ratio exceeds
``inlier_ratio_threshold`` (5%). Scene recall = matched / gt pairs.

Works from an in-memory :class:`FragmentFeatures` store or from the
reference's on-disk .npy layout; scenes run concurrently in a thread pool
(the reference forks one process per scene, test.py:215-224 — here the
work is numpy-bound and releases the GIL in the matmuls).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from d3feat_tpu_torch.eval.gtlog import load_gt_log
from d3feat_tpu_torch.eval.matching import inlier_stats, mutual_nn_numpy, select_keypoints
from d3feat_tpu_torch.utils.timer import AverageMeter


@dataclass
class FragmentFeatures:
    """Per-scene extracted features: fragment id -> arrays."""

    keypts: Dict[int, np.ndarray] = field(default_factory=dict)      # [N,3]
    descriptors: Dict[int, np.ndarray] = field(default_factory=dict)  # [N,32]
    scores: Dict[int, np.ndarray] = field(default_factory=dict)       # [N] or [N,1]

    def add(self, frag_id: int, keypts, desc, scores) -> None:
        self.keypts[frag_id] = np.asarray(keypts)
        self.descriptors[frag_id] = np.asarray(desc)
        self.scores[frag_id] = np.asarray(scores)

    @property
    def num_fragments(self) -> int:
        return len(self.keypts)

    # --- reference-compatible on-disk layout (test.py:113-127) ----------
    def save(self, save_path: str, scene: str, desc_name: str = "D3Feat") -> None:
        for sub in ("keypoints", "descriptors", "scores"):
            os.makedirs(os.path.join(save_path, sub, scene), exist_ok=True)
        for fid in self.keypts:
            name = f"cloud_bin_{fid}"
            np.save(os.path.join(save_path, "keypoints", scene, name + ".npy"),
                    self.keypts[fid])
            np.save(
                os.path.join(save_path, "descriptors", scene,
                             name + f".{desc_name}.npy"),
                self.descriptors[fid],
            )
            np.save(os.path.join(save_path, "scores", scene, name + ".npy"),
                    self.scores[fid])

    @classmethod
    def load(cls, save_path: str, scene: str,
             desc_name: str = "D3Feat") -> "FragmentFeatures":
        out = cls()
        kdir = os.path.join(save_path, "keypoints", scene)
        for fn in os.listdir(kdir):
            if not fn.endswith(".npy"):
                continue
            fid = int(fn.replace("cloud_bin_", "").replace(".npy", ""))
            name = f"cloud_bin_{fid}"
            out.add(
                fid,
                np.load(os.path.join(kdir, name + ".npy")),
                np.nan_to_num(  # reference: test.py:48-49
                    np.load(os.path.join(save_path, "descriptors", scene,
                                         name + f".{desc_name}.npy"))
                ),
                np.load(os.path.join(save_path, "scores", scene, name + ".npy")),
            )
        return out


@dataclass
class SceneResult:
    scene: str
    recall: float            # percent
    avg_inlier_num: float
    avg_inlier_ratio: float
    gt_pairs: int
    matched_pairs: int
    # per-pair inlier ratios keyed "i_j": the distribution behind the
    # recall number, for statistically meaningful A/B comparisons
    pair_ratios: "Dict[str, float]" = None


def register_scene(
    features: FragmentFeatures,
    gt_log: Dict[str, np.ndarray],
    *,
    scene: str = "",
    num_points: int = 250,
    inlier_ratio_threshold: float = 0.05,
    distance_threshold: float = 0.10,
    random_points: bool = False,
    seed: int = 0,
) -> SceneResult:
    """Feature-match recall for one scene (reference: test.py:20-82)."""
    rng = np.random.default_rng(seed)
    gt_matches = 0
    pred_matches = 0
    inlier_num = AverageMeter()
    inlier_ratio = AverageMeter()
    pair_ratios: Dict[str, float] = {}

    # cache per-fragment keypoint selections (same selection for every pair,
    # as in the reference where scores are fixed per fragment)
    sel_cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def selected(fid: int):
        if fid not in sel_cache:
            idx = select_keypoints(
                features.scores[fid], num_points, random=random_points, rng=rng
            )
            sel_cache[fid] = (
                features.keypts[fid][idx],
                np.nan_to_num(features.descriptors[fid][idx]),
                idx,
            )
        return sel_cache[fid]

    n = features.num_fragments
    for id1 in range(n):
        for id2 in range(id1 + 1, n):
            key = f"{id1}_{id2}"
            if key not in gt_log:
                continue  # <30% overlap pair: not scored (test.py:36-39)
            s_kp, s_desc, _ = selected(id1)
            t_kp, t_desc, _ = selected(id2)
            corr = mutual_nn_numpy(s_desc, t_desc)
            num_in, ratio = inlier_stats(
                s_kp, t_kp, corr, gt_log[key], distance_threshold
            )
            gt_matches += 1
            if ratio > inlier_ratio_threshold:
                pred_matches += 1
            inlier_num.update(num_in)
            inlier_ratio.update(ratio)
            pair_ratios[key] = float(ratio)

    recall = pred_matches * 100.0 / max(gt_matches, 1)
    return SceneResult(
        scene=scene, recall=recall,
        avg_inlier_num=inlier_num.avg, avg_inlier_ratio=inlier_ratio.avg,
        gt_pairs=gt_matches, matched_pairs=pred_matches,
        pair_ratios=pair_ratios,
    )


def evaluate_scenes(
    scene_features: Dict[str, FragmentFeatures],
    gt_root: str,
    *,
    num_points: int = 250,
    inlier_ratio_threshold: float = 0.05,
    distance_threshold: float = 0.10,
    random_points: bool = False,
    max_workers: int = 8,
) -> Tuple[List[SceneResult], Dict[str, float]]:
    """All scenes concurrently; returns per-scene results + overall averages
    (reference: test.py:215-234). ``gt_root`` holds
    ``<scene>-evaluation/gt.log`` per scene."""

    def one(scene_and_feats):
        scene, feats = scene_and_feats
        gt = load_gt_log(os.path.join(gt_root, f"{scene}-evaluation"))
        return register_scene(
            feats, gt, scene=scene, num_points=num_points,
            inlier_ratio_threshold=inlier_ratio_threshold,
            distance_threshold=distance_threshold,
            random_points=random_points,
        )

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(one, scene_features.items()))

    summary = {
        "avg_recall": float(np.mean([r.recall for r in results])),
        "avg_inlier_num": float(np.mean([r.avg_inlier_num for r in results])),
        "avg_inlier_ratio": float(np.mean([r.avg_inlier_ratio for r in results])),
    }
    return results, summary
