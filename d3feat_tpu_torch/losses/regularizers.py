"""Deformable-KPConv regularizer (port of
``d3feat_tpu.losses.regularizers``).

For every deformable conv: (a) fitting, the mean of the least squared
distance from each deformed kernel point to the input points, over
extent^2; (b) repulsion, a squared hinge on the pairwise distances of the
deformed kernel points below ``repulse_extent``, the gradient taken through
one side of each pair only.
"""

from __future__ import annotations

from typing import Sequence

import torch


def p2p_fitting_regularizer(auxes: Sequence, *, KP_extent: float, repulse_extent: float = 1.2,
                            deform_fitting_power: float = 1.0) -> torch.Tensor:
    """Scalar regularizer over the ``models.kpconv.KPConvAux`` of all
    deformable convs: ``power * (2 fitting + repulsion)``."""
    fitting = 0.0
    repulsive = 0.0
    for aux in auxes:
        if aux.min_d2 is None:
            continue
        fitting = fitting + (aux.min_d2 / (KP_extent**2)).abs().mean()

        locs = aux.deformed_kp / KP_extent                                      # [Q, K, 3]
        k = locs.shape[1]
        diff = locs[:, :, None, :] - locs[:, None, :, :].detach()
        dist = torch.sqrt((diff**2).sum(-1) + 1e-12)                            # [Q, K, K]
        off_diag = ~torch.eye(k, dtype=torch.bool, device=locs.device)
        hinge = torch.clamp(dist - repulse_extent, max=0.0) ** 2
        rep = torch.where(off_diag, hinge, 0.0).sum(2)                          # [Q, K]
        repulsive = repulsive + rep.sum(1).mean() / k
    return deform_fitting_power * (2.0 * fitting + repulsive)
