"""Offline 3DMatch training-data preparation (port of
``d3feat_tpu.data.prepare``, copied as it is).

The reference ships no generation code for its training pickles — it
points users at a pre-built download (reference: README.md:33-39; the
pickles `3DMatch_{split}_{0.030}_points.pkl` / `..._keypts.pkl` are loaded
at datasets/ThreeDMatch.py:69-79). This module closes that gap: from raw
fragment PLYs + ground-truth pose logs it voxel-downsamples every fragment
and computes dense correspondences for each overlapping pair, emitting
pickles in exactly the layout the training dataset consumes.

Correspondences: target points are moved into the source frame by the GT
pose; each source point matches its nearest target point within
``threshold`` (mutual filtering optional). The neighbor search takes the
native C++ cell-grid route (``d3feat_tpu_torch/native/``, OpenMP) by
default, or the chunked numpy brute force with ``use_native=False``. The
native search computes in float32, numpy in float64: they can part only
where that rounding decides, on a tie between near-equidistant targets or
a distance at the threshold. Unlike the JAX package, a native build or
load failure raises: there is no silent fallback to numpy.
"""

from __future__ import annotations

import os
import pickle
import re
from os.path import join
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from d3feat_tpu_torch.data.ply import read_ply_points
from d3feat_tpu_torch.data.threedmatch import voxel_downsample
from d3feat_tpu_torch.eval.gtlog import load_gt_log


def _nn_within(src: np.ndarray, tgt: np.ndarray, threshold: float,
               use_native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """For each src point: (nearest tgt index, within-threshold mask), by
    the native radius search or (``use_native=False``) chunked brute force."""
    if use_native:
        from d3feat_tpu_torch import native

        nbrs = native.radius_neighbors_batch(src, tgt, [len(src)], [len(tgt)], threshold,
                                             1)[:, 0]
        ok = nbrs < len(tgt)
        return np.where(ok, nbrs, 0), ok
    idx = np.zeros(len(src), np.int64)
    ok = np.zeros(len(src), bool)
    for i0 in range(0, len(src), 2048):
        chunk = src[i0 : i0 + 2048]
        d2 = np.sum((chunk[:, None] - tgt[None]) ** 2, axis=-1)
        j = np.argmin(d2, axis=1)
        idx[i0 : i0 + len(chunk)] = j
        ok[i0 : i0 + len(chunk)] = d2[np.arange(len(chunk)), j] <= threshold**2
    return idx, ok


def compute_correspondences(
    src: np.ndarray,
    tgt: np.ndarray,
    trans: np.ndarray,
    threshold: float,
    *,
    mutual: bool = True,
    use_native: bool = True,
) -> np.ndarray:
    """[M, 2] (src_idx, tgt_idx) pairs within ``threshold`` after moving the
    target cloud into the source frame by the 4x4 GT pose ``trans``; the
    search by ``_nn_within``'s route ``use_native``."""
    tgt_in_src = tgt @ trans[:3, :3].T + trans[:3, 3]
    s2t, ok_s = _nn_within(src, tgt_in_src, threshold, use_native)
    if not mutual:
        src_idx = np.nonzero(ok_s)[0]
        return np.stack([src_idx, s2t[src_idx]], axis=1).astype(np.int32)
    t2s, ok_t = _nn_within(tgt_in_src, src, threshold, use_native)
    src_idx = np.nonzero(ok_s)[0]
    keep = t2s[s2t[src_idx]] == src_idx
    keep &= ok_t[s2t[src_idx]]
    src_idx = src_idx[keep]
    return np.stack([src_idx, s2t[src_idx]], axis=1).astype(np.int32)


def _fragment_id(path: str) -> int:
    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def prepare_split(
    root: str,
    scenes: Sequence[str],
    *,
    split: str = "train",
    downsample: float = 0.03,
    threshold: Optional[float] = None,
    min_overlap_pairs: int = 1,
    out_dir: Optional[str] = None,
    verbose: bool = False,
    use_native: bool = True,
) -> Tuple[str, str]:
    """Build the training pickles for ``scenes``.

    Expects per scene: ``<root>/fragments/<scene>/*.ply`` and a pose log at
    ``<root>/fragments/<scene>/gt.log`` (or ``<scene>-evaluation/gt.log``).
    Writes ``3DMatch_{split}_{downsample:.3f}_points.pkl`` (id -> [N,3]) and
    ``..._keypts.pkl`` ("src@tgt" -> [M,2]) under ``out_dir`` (default:
    ``root``) and returns their paths.
    """
    threshold = threshold if threshold is not None else downsample * 1.25
    out_dir = out_dir or root
    points: Dict[str, np.ndarray] = {}
    keypts: Dict[str, np.ndarray] = {}

    for scene in scenes:
        frag_dir = join(root, "fragments", scene)
        plys = sorted(
            (p for p in os.listdir(frag_dir) if p.endswith(".ply")),
            key=_fragment_id,
        )
        gt_path = None
        for cand in (join(frag_dir, "gt.log"),
                     join(root, f"{scene}-evaluation", "gt.log"),
                     join(root, "fragments", f"{scene}-evaluation", "gt.log")):
            if os.path.exists(cand):
                gt_path = cand
                break
        if gt_path is None:
            raise FileNotFoundError(f"no gt.log found for scene {scene!r}")
        poses = load_gt_log(gt_path)

        clouds = []
        for p in plys:
            raw = read_ply_points(join(frag_dir, p)).astype(np.float64)
            clouds.append(voxel_downsample(raw, downsample))
        for i, c in enumerate(clouds):
            points[f"{scene}/cloud_bin_{i}"] = c.astype(np.float32)

        for key, pose in poses.items():
            i, j = (int(x) for x in key.split("_"))
            if i >= len(clouds) or j >= len(clouds):
                continue
            corr = compute_correspondences(
                clouds[i], clouds[j], pose, threshold, use_native=use_native
            )
            if len(corr) >= min_overlap_pairs:
                keypts[f"{scene}/cloud_bin_{i}@{scene}/cloud_bin_{j}"] = corr
            if verbose:
                print(f"[prepare] {scene} {i}-{j}: {len(corr)} correspondences")

    os.makedirs(out_dir, exist_ok=True)
    pts_path = join(out_dir, f"3DMatch_{split}_{downsample:.3f}_points.pkl")
    kp_path = join(out_dir, f"3DMatch_{split}_{downsample:.3f}_keypts.pkl")
    with open(pts_path, "wb") as f:
        pickle.dump(points, f)
    with open(kp_path, "wb") as f:
        pickle.dump(keypts, f)
    return pts_path, kp_path
