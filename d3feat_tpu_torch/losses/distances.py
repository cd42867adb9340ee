"""Pairwise distance matrices (port of ``d3feat_tpu.losses.distances``).

The reference's cdist metrics with the same epsilons: 'euclidean'
(sqrt + 1e-12), 'sqeuclidean', 'cityblock', 'cosine' (sqrt(2 - 2 a.b),
unit-norm inputs) and 'arccosine'. Gradients at ties follow JAX: ``|d|``
has gradient 1 at 0 (``torch.abs`` gives 0) and the clip is a maximum then
a minimum (gradient 0.5 on its bounds; ``torch.clip`` gives 1).
"""

from __future__ import annotations

import torch


def cdist(a: torch.Tensor, b: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """[B1, B2] pairwise distances between the rows of ``a`` and ``b``."""
    if metric == "cosine":
        return torch.sqrt(torch.maximum(2.0 - 2.0 * (a @ b.T), a.new_zeros(())))
    if metric == "arccosine":
        one = a.new_ones(())
        return torch.arccos(torch.minimum(torch.maximum(a @ b.T, -one), one))
    diffs = a[:, None, :] - b[None, :, :]
    if metric == "sqeuclidean":
        return (diffs**2).sum(-1)
    if metric == "euclidean":
        return torch.sqrt((diffs**2).sum(-1) + 1e-12)
    if metric == "cityblock":
        return torch.where(diffs >= 0, diffs, -diffs).sum(-1)
    raise NotImplementedError(f"cdist metric {metric!r} not implemented")
