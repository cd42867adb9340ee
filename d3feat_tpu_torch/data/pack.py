"""Fixed-capacity packing of fragments for the on-device pipeline.

Host-side numpy, copied from ``d3feat_tpu.data.pack`` (the port imports
nothing of the JAX package): rows [0, n0) hold cloud 0, [n0, n0 + n1)
cloud 1, ..., and shadow padding at ``SHADOW_COORD`` fills the tail.
Training pairs also carry their correspondences, padded to a fixed count
with a validity mask, and the anchors' spatial distances, padded with
``_FAR`` so padded pairs never enter the safe-radius negative mask.
Also reads the committed held-out fragments under ``artifacts/eval_cache``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, NamedTuple, Optional

import numpy as np

SHADOW_COORD = 1.0e6  # shadow/padding coordinate (same value as the reference)
_FAR = 1.0e4  # padding value of dist_keypts: always outside safe_radius


class PackedPair(NamedTuple):
    points: np.ndarray       # [C0, 3] float32 stacked + shadow-padded
    features: np.ndarray     # [C0, F] float32, zero padding
    lengths: np.ndarray      # [2] int32
    corr: np.ndarray         # [M, 2] int32 (anchor idx in cloud 0, positive in cloud 1)
    corr_valid: np.ndarray   # [M] bool
    dist_keypts: np.ndarray  # [M, M] float32


def pack_pair(pts0: np.ndarray, pts1: np.ndarray, feat0: np.ndarray, feat1: np.ndarray,
              corr: Optional[np.ndarray], dist_keypts: Optional[np.ndarray], *,
              point_capacity: int, corr_capacity: int) -> PackedPair:
    """One training pair in the static layout of the train step."""
    n0, n1 = len(pts0), len(pts1)
    if n0 + n1 > point_capacity:
        raise ValueError(f"pair has {n0}+{n1} points > capacity {point_capacity}; "
                         "downsample more or use a larger bucket")
    points = np.full((point_capacity, 3), SHADOW_COORD, np.float32)
    feats = np.zeros((point_capacity, feat0.shape[1]), np.float32)
    points[:n0] = pts0
    points[n0 : n0 + n1] = pts1
    feats[:n0] = feat0
    feats[n0 : n0 + n1] = feat1
    m = corr_capacity
    corr_out = np.zeros((m, 2), np.int32)
    corr_valid = np.zeros((m,), bool)
    dk_out = np.full((m, m), _FAR, np.float32)
    if corr is not None and len(corr) > 0:
        k = min(len(corr), m)
        corr_out[:k] = corr[:k]
        corr_valid[:k] = True
        if dist_keypts is not None:
            dk_out[:k, :k] = dist_keypts[:k, :k]
    return PackedPair(points=points, features=feats, lengths=np.array([n0, n1], np.int32),
                      corr=corr_out, corr_valid=corr_valid, dist_keypts=dk_out)

EVAL_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "eval_cache")


def pack_single(
    pts: np.ndarray, feat: np.ndarray, *, point_capacity: int
) -> Dict[str, np.ndarray]:
    """Single-cloud packing for feature extraction (second length 0)."""
    n = len(pts)
    if n > point_capacity:
        raise ValueError(f"cloud has {n} points > capacity {point_capacity}")
    points = np.full((point_capacity, 3), SHADOW_COORD, np.float32)
    feats = np.zeros((point_capacity, feat.shape[1]), np.float32)
    points[:n] = pts
    feats[:n] = feat
    return {
        "points": points,
        "features": feats,
        "lengths": np.array([n, 0], np.int32),
    }


def pack_fragments(
    clouds, *, point_capacity: int, num_clouds: int
) -> Dict[str, np.ndarray]:
    """Pack up to ``num_clouds`` independent fragments into one stacked
    batch (fragments ride the cloud axis). Unused cloud slots get length 0.
    """
    if len(clouds) > num_clouds:
        raise ValueError(f"{len(clouds)} fragments > num_clouds {num_clouds}")
    total = sum(len(c) for c in clouds)
    if total > point_capacity:
        raise ValueError(f"{total} points > capacity {point_capacity}")
    points = np.full((point_capacity, 3), SHADOW_COORD, np.float32)
    feats = np.zeros((point_capacity, 1), np.float32)
    lengths = np.zeros((num_clouds,), np.int32)
    row = 0
    for i, c in enumerate(clouds):
        n = len(c)
        points[row : row + n] = c
        feats[row : row + n] = 1.0
        lengths[i] = n
        row += n
    return {"points": points, "features": feats, "lengths": lengths}


def choose_bucket(n_points: int, buckets) -> int:
    """Smallest bucket capacity >= n_points."""
    for b in sorted(buckets):
        if n_points <= b:
            return int(b)
    raise ValueError(f"{n_points} points exceed the largest bucket {max(buckets)}")


def load_eval_fragments(min_points: int = 0, max_points: int = 1 << 30,
                        cache_dir: str = EVAL_CACHE) -> List[np.ndarray]:
    """[N, 3] float32 fragments (``frag_<i>`` keys) of every
    ``scene_*.npz`` in ``cache_dir``, in file then fragment order, keeping
    those with ``min_points <= N <= max_points``."""
    files = sorted(glob.glob(os.path.join(cache_dir, "scene_*.npz")))
    if not files:
        raise FileNotFoundError(f"no scene_*.npz fragments under {cache_dir}")
    out = []
    for path in files:
        with np.load(path, allow_pickle=False) as z:
            keys = sorted((k for k in z.files if re.fullmatch(r"frag_\d+", k)),
                          key=lambda k: int(k[5:]))
            for k in keys:
                f = np.asarray(z[k], np.float32)
                if min_points <= len(f) <= max_points:
                    out.append(f)
    return out
