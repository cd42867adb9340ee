"""SE(3) + noise augmentation for training pairs (host-side numpy); port
of ``d3feat_tpu.data.augment``, copied as it is.

Counterpart of the reference augmentation (reference:
datasets/ThreeDMatch.py:14-32,117-127): a random rotation (about one random
coordinate axis when ``augment_axis == 1``, else the composed XYZ rotation),
a uniform random translation in [0, augment_translation)^3 applied to the
target cloud, and per-point uniform noise in [0, augment_noise) added to
both clouds.
"""

from __future__ import annotations

import numpy as np


def random_rotation(
    rng: np.random.Generator, augment_axis: int = 1, augment_rotation: float = 1.0
) -> np.ndarray:
    """[3, 3] rotation; one random principal axis if augment_axis == 1."""
    angles = rng.random(3) * 2 * np.pi * augment_rotation
    c, s = np.cos(angles), np.sin(angles)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    if augment_axis == 1:
        return [rx, ry, rz][rng.integers(3)]
    return rx @ ry @ rz


def random_so3(rng: np.random.Generator) -> np.ndarray:
    """[3, 3] uniformly random PROPER rotation (det +1).

    QR of a Gaussian matrix gives a Haar-random orthogonal matrix whose
    determinant is -1 half the time; an improper frame mirrors the local
    geometry, which is not a rigid motion — descriptors cannot (and should
    not learn to) match reflected neighborhoods. Fix the sign by negating
    one column when det < 0.
    """
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def random_translation(
    rng: np.random.Generator, augment_translation: float = 0.5
) -> np.ndarray:
    return rng.random(3) * augment_translation


def augment_pair(
    rng: np.random.Generator,
    src: np.ndarray,
    tgt: np.ndarray,
    *,
    augment_noise: float = 0.005,
    augment_axis: int = 1,
    augment_rotation: float = 1.0,
    augment_translation: float = 0.5,
):
    """Apply the reference's train-time augmentation to a fragment pair.

    Returns (src', tgt', gt_trans [4,4]) where tgt' = R tgt + T + noise.
    """
    rot = random_rotation(rng, augment_axis, augment_rotation)
    trans = random_translation(rng, augment_translation)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = rot
    gt[:3, 3] = trans
    tgt_out = tgt @ rot.T + trans
    src_out = src + rng.random(src.shape) * augment_noise
    tgt_out = tgt_out + rng.random(tgt_out.shape) * augment_noise
    return src_out.astype(np.float32), tgt_out.astype(np.float32), gt
