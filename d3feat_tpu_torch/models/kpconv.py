"""Rigid KPConv parameters (port of the parameter structure of
``d3feat_tpu.models.kpconv``).

A rigid KPConv holds ``weights`` [KP, Cin, Cout] and the fixed
``kernel_points`` [KP, 3] (a buffer: stored with the weights, never
trained). Its forward at this configuration is the K2 band kernel
(``models.blocks.apply_band_kpconv``); the reference's gather formulation
is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def torch_kaiming_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U(-b, b), b = sqrt(3) * sqrt(2 / 6) / sqrt(fan_in), fan_in computed
    the torch way (dim 1 x trailing dims) — the reference's statistics."""
    fan_in = shape[1] if len(shape) == 2 else shape[1] * math.prod(shape[2:])
    bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * 2.0 - 1.0) * bound


class KPConv(nn.Module):
    """Rigid kernel-point convolution parameters."""

    def __init__(self, kernel_points: np.ndarray, in_dim: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        kp = torch.as_tensor(kernel_points, dtype=torch.float32)
        self.weights = nn.Parameter(
            torch_kaiming_uniform((kp.shape[0], in_dim, out_dim), generator))
        self.register_buffer("kernel_points", kp.to(generator.device))
