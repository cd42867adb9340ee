"""Descriptor metric losses over padded correspondence batches (port of
``d3feat_tpu.losses.descriptor``): the circle loss (the default) and the
batch-hard contrastive loss, every reduction masked so the result equals
the reference's on the valid sub-block.

Gradients follow JAX's rules: ``torch.maximum`` (not ``clamp``) where the
reference takes ``jnp.maximum`` of a differentiable value, ``amax``/
``amin`` for its reductions, ``logaddexp`` for its softplus.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from d3feat_tpu_torch.losses.distances import cdist

_BIG = 1.0e5
_NEG_INF = -1.0e9


class DescLossResult(NamedTuple):
    loss: torch.Tensor      # scalar
    accuracy: torch.Tensor  # scalar, percent of rows where d_pos < d_neg
    d_pos: torch.Tensor     # scalar mean furthest-positive distance
    d_neg: torch.Tensor     # scalar mean average-negative distance
    dists: torch.Tensor     # [M, M] descriptor distances (for the detector loss)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, x.new_zeros(()))


def _masked_stats(dists: torch.Tensor, valid: torch.Tensor):
    """furthest_positive, closest_negative, average_negative, accuracy and
    the valid count over the valid sub-block."""
    m = dists.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=dists.device)
    vpair = valid[:, None] & valid[None, :]
    furthest_positive = torch.where(eye & vpair, dists, 0.0).amax(1)
    closest_negative = torch.where(vpair & ~eye, dists, _BIG).amin(1)
    n = torch.clamp(valid.sum(), min=1).to(dists.dtype)
    row_sum = torch.where(vpair, dists, 0.0).sum(1)
    average_negative = (row_sum - furthest_positive) / torch.clamp(n - 1.0, min=1.0)
    diff = furthest_positive - closest_negative
    accuracy = ((diff < 0) & valid).sum() * 100.0 / n
    return furthest_positive, closest_negative, average_negative, accuracy, n


def circle_loss(anchor, positive, dist_keypts, valid, *, dist_type: str = "euclidean",
                log_scale: float = 10.0, safe_radius: float = 0.10, pos_margin: float = 0.1,
                neg_margin: float = 1.4) -> DescLossResult:
    """Circle loss: ``anchor``/``positive`` [M, D] (row i of each is a true
    pair), ``dist_keypts`` [M, M] spatial distances between the anchors,
    ``valid`` [M] bool. Opposite-class pairs are shifted by +-1e5 (their
    detached weight is 0, they still add exp(0) to the logsumexp);
    padding is excluded with a -1e9 fill."""
    dists = cdist(anchor, positive, metric=dist_type)
    vpair = valid[:, None] & valid[None, :]
    zero = dists.new_zeros(())
    fp, _, avg_neg, accuracy, n = _masked_stats(dists, valid)

    neg_mask = (dist_keypts > safe_radius) & vpair
    pos = dists - _BIG * neg_mask.to(dists.dtype)
    pos_weight = torch.maximum(pos - pos_margin, zero).detach()
    pos_arg = torch.where(vpair, log_scale * (pos - pos_margin) * pos_weight, _NEG_INF)
    lse_pos_row = torch.logsumexp(pos_arg, -1)
    lse_pos_col = torch.logsumexp(pos_arg, -2)

    neg = dists + _BIG * (~neg_mask).to(dists.dtype)
    neg_weight = torch.maximum(neg_margin - neg, zero).detach()
    neg_arg = torch.where(vpair, log_scale * (neg_margin - neg) * neg_weight, _NEG_INF)
    lse_neg_row = torch.logsumexp(neg_arg, -1)
    lse_neg_col = torch.logsumexp(neg_arg, -2)

    loss_row = _softplus(lse_pos_row + lse_neg_row) / log_scale
    loss_col = _softplus(lse_pos_col + lse_neg_col) / log_scale
    loss = torch.where(valid, loss_row + loss_col, 0.0).sum() / n
    d_pos = torch.where(valid, fp, 0.0).sum() / n
    d_neg = torch.where(valid, avg_neg, 0.0).sum() / n
    return DescLossResult(loss, accuracy, d_pos, d_neg, dists)


def contrastive_loss(anchor, positive, dist_keypts, valid, *, metric: str = "euclidean",
                     pos_margin: float = 0.1, neg_margin: float = 1.4,
                     safe_radius: float = 0.25) -> DescLossResult:
    """Batch-hard contrastive loss; spatially close off-diagonal pairs get
    +10 so they are never negatives."""
    dists = cdist(anchor, positive, metric=metric)
    m = dists.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=dists.device)
    vpair = valid[:, None] & valid[None, :]
    close = (dist_keypts + 10.0 * eye) < safe_radius
    dists = dists + torch.where(close & vpair, 10.0, 0.0)
    fp, cn, avg_neg, accuracy, n = _masked_stats(dists, valid)
    zero = dists.new_zeros(())
    per_row = torch.maximum(fp - pos_margin, zero) + torch.maximum(neg_margin - cn, zero)
    loss = torch.where(valid, per_row, 0.0).sum() / n
    d_pos = torch.where(valid, fp, 0.0).sum() / n
    d_neg = torch.where(valid, avg_neg, 0.0).sum() / n
    return DescLossResult(loss, accuracy, d_pos, d_neg, dists)
