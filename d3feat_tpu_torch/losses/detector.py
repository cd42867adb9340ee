"""Self-supervised detector loss (port of ``d3feat_tpu.losses.detector``):
the mean over valid correspondences of
``(furthest_positive - closest_negative) * (anc_score + pos_score)``."""

from __future__ import annotations

import torch


def det_loss(dists: torch.Tensor, anc_score: torch.Tensor, pos_score: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """``dists`` [M, M] descriptor distances, ``anc_score``/``pos_score``
    [M, 1] detection scores at the correspondences, ``valid`` [M] bool."""
    m = dists.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=dists.device)
    vpair = valid[:, None] & valid[None, :]
    furthest_positive = torch.where(eye & vpair, dists, 0.0).amax(1)
    closest_negative = torch.where(vpair & ~eye, dists, 1.0e5).amin(1)
    gap = furthest_positive - closest_negative
    per_row = gap * (anc_score[:, 0] + pos_score[:, 0])
    n = torch.clamp(valid.sum(), min=1).to(dists.dtype)
    return torch.where(valid, per_row, 0.0).sum() / n
