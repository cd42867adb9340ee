"""Descriptor matching: keypoint selection + mutual nearest neighbors
(port of ``d3feat_tpu.eval.matching``).

Counterpart of the reference matching path (reference:
geometric_registration/common.py:5-21 ``build_correspondence``;
test.py:52-57 keypoint selection). ``select_keypoints``,
``mutual_nn_numpy`` and ``inlier_stats`` are the JAX package's host numpy,
copied as it is; ``mutual_nn_matrix`` is one descriptor product on an
explicit device, in full f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def select_keypoints(
    scores: np.ndarray, num_points: int, *, random: bool = False,
    rng: np.random.Generator | None = None, on_short: str = "warn",
) -> np.ndarray:
    """Indices of the ``num_points`` top-score keypoints (or random ones)
    (reference: test.py:52-57 — argsort tail, ascending order).

    Guard: fewer than ``num_points`` strictly-positive scores means the
    top-k is padded with arbitrary zero-score (undetected) points — and,
    when the scores came through ``config.eval_gate_topm``, it is exactly
    the condition under which the gate's top-k-exactness argument no
    longer holds (gating only zeroes, so per fragment the positive-score
    count == detected-candidates-inside-top-M; exact top-k requires that
    count >= k; see models/kpfcnn.detection_scores). ``on_short``:
    'warn' (default) | 'raise' | 'ignore'.
    """
    scores = np.asarray(scores).squeeze()
    if random:
        rng = rng or np.random.default_rng()
        return rng.choice(len(scores), num_points)
    if on_short != "ignore":
        detected = int(np.sum(scores > 0.0))
        if detected < num_points:
            msg = (
                f"only {detected} positive-score keypoints for a top-"
                f"{num_points} selection: the tail is arbitrary zero-score "
                f"points (and eval_gate_topm exactness is void for this "
                f"fragment — raise the gate's M or disable it)."
            )
            if on_short == "raise":
                raise RuntimeError(msg)
            import warnings

            warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return np.argsort(scores)[-num_points:]


def mutual_nn_numpy(source_desc: np.ndarray,
                    target_desc: np.ndarray) -> np.ndarray:
    """[M, 2] mutual-NN pairs in descriptor space (host numpy).

    Distance = sqrt(2 - 2 S.T^T), valid for L2-normalized descriptors
    (reference: common.py:12).
    """
    sim = source_desc @ target_desc.T
    d2 = np.maximum(2.0 - 2.0 * sim, 0.0)
    s_nn = np.argmin(d2, axis=1)
    t_nn = np.argmin(d2, axis=0)
    src = np.arange(len(source_desc))
    mutual = t_nn[s_nn] == src
    return np.stack([src[mutual], s_nn[mutual]], axis=1)


def mutual_nn_matrix(source_desc: torch.Tensor, target_desc: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape mutual-NN: ([Ns] target index, [Ns] bool mutual mask),
    on the descriptors' device.

    Keeps every source row (no dynamic compaction); hosts compact with the
    mask. The product runs in full f32 whatever ``allow_tf32`` says, and
    ``torch.argmax`` takes the first index among equal similarities, as
    ``jnp.argmax`` does.
    """
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sim = source_desc.float() @ target_desc.float().T  # [Ns, Nt]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    s_nn = torch.argmax(sim, dim=1)
    t_nn = torch.argmax(sim, dim=0)
    src = torch.arange(sim.shape[0], device=sim.device)
    mutual = t_nn[s_nn] == src
    return s_nn, mutual


def mutual_nn(source_desc, target_desc, device="cuda") -> np.ndarray:
    """Mutual-NN on ``device`` with host compaction; same result as
    :func:`mutual_nn_numpy` (up to argmin tie-breaking)."""
    from d3feat_tpu_torch import resolve_device

    dev = resolve_device(device)
    s_nn, mutual = mutual_nn_matrix(torch.as_tensor(np.asarray(source_desc), device=dev),
                                    torch.as_tensor(np.asarray(target_desc), device=dev))
    s_nn, mutual = s_nn.cpu().numpy(), mutual.cpu().numpy()
    src = np.arange(len(s_nn))
    return np.stack([src[mutual], s_nn[mutual]], axis=1)


def inlier_stats(
    source_keypts: np.ndarray,
    target_keypts: np.ndarray,
    corr: np.ndarray,
    gt_trans: np.ndarray,
    distance_threshold: float,
) -> Tuple[int, float]:
    """(num_inliers, inlier_ratio) after moving target keypoints by the GT
    pose (reference: test.py:65-72)."""
    if len(corr) == 0:
        return 0, 0.0
    frag1 = source_keypts[corr[:, 0]]
    t = target_keypts[corr[:, 1]]
    frag2 = t @ gt_trans[:3, :3].T + gt_trans[:3, 3]
    dist = np.linalg.norm(frag1 - frag2, axis=1)
    num_inliers = int(np.sum(dist < distance_threshold))
    return num_inliers, num_inliers / len(dist)
