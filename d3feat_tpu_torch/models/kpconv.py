"""Rigid KPConv (port of ``d3feat_tpu.models.kpconv``): its parameters and
the gather KPConv.

A rigid KPConv holds ``weights`` [KP, Cin, Cout] and the fixed
``kernel_points`` [KP, 3] (a buffer without gradient; the optimizer still
decays and traces it, as the JAX package's optimizer does the parameter
leaf it keeps there). A block whose conv the band kernels cover runs K2
forward and K4 backward (``models.blocks.apply_band_kpconv``); every other
rigid KPConv runs ``kpconv`` here, the reference's gather formulation in
PyTorch ops: any influence (``constant``, ``linear``, ``gaussian``) and
aggregation (``sum``, ``closest``), on any pyramid (original indices or
sorted positions: it only reads the points and lists it is given),
differentiable by autograd in the features and the weights. The deformable
KPConv is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SHADOW_COORD = 1.0e6


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


def influence(sq_d: torch.Tensor, extent: float, mode: str) -> torch.Tensor:
    """Kernel-point influence of squared distances ``sq_d``
    (``d3feat_tpu/models/kpconv.py::_influence``): 1, ``max(1 - d /
    extent, 0)`` with ``sqrt(0)`` guarded, or ``exp(-sq_d / (2 sigma^2 +
    1e-9))`` at ``sigma = 0.3 extent``."""
    if mode == "constant":
        return torch.ones_like(sq_d)
    if mode == "linear":
        positive = sq_d > 0.0
        d = torch.sqrt(torch.where(positive, sq_d, 1.0))
        d = torch.where(positive, d, 0.0)
        return torch.clamp(1.0 - d / extent, min=0.0)
    if mode == "gaussian":
        sigma = extent * 0.3
        return torch.exp(-sq_d / (2.0 * sigma**2 + 1e-9))
    raise ValueError(f"unknown KP_influence {mode!r}")


def gather_rows(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """``x`` rows at ``inds``, where index ``len(x)`` (the shadow) reads a
    zero row. An embedding lookup with the shadow as padding index: the
    same values as indexing the zero-extended ``x``, but its backward sums
    the rows' gradients by sorted segments and skips the shadow entries,
    where indexing's backward walks each repeated index serially (the
    shadow is repeated in most lists of a padded level)."""
    ext = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return F.embedding(inds.long(), ext, padding_idx=x.shape[0])


def kpconv(q_pts: torch.Tensor, s_pts: torch.Tensor, neighb_inds: torch.Tensor,
           x: torch.Tensor, weights: torch.Tensor, kernel_points: torch.Tensor, *,
           KP_extent: float, KP_influence: str = "linear", aggregation_mode: str = "sum",
           compute_dtype=torch.float32) -> torch.Tensor:
    """Rigid gather KPConv (``d3feat_tpu/models/kpconv.py::kpconv`` and
    ``_rigid_core``): ``[Q, Cout]`` float32.

    ``q_pts`` [Q, 3] query points, ``s_pts`` [S, 3] supports,
    ``neighb_inds`` [Q, nn] with shadow ``S`` (a point at ``SHADOW_COORD``
    with zero features), ``x`` [S, Cin], ``weights`` [KP, Cin, Cout],
    ``kernel_points`` [KP, 3] (no gradient). The squared distances to the
    kernel points come from the expansion ``|n|^2 - 2 n.kp + |kp|^2``
    clamped at 0, written out elementwise so that no matrix unit rounds it.
    The first product multiplies the compute-dtype features and weights in
    float32, so a bf16 run sums exact products of bf16 operands in f32 as
    the reference's ``preferred_element_type=f32``; the second rounds its
    bf16 product to bf16. The result is divided by the count of neighbours
    whose compute-dtype feature sum is > 0, at least 1."""
    kp = kernel_points.detach().float()
    s_ext = torch.cat([s_pts.detach().float(), s_pts.new_full((1, 3), SHADOW_COORD)])
    nb = s_ext[neighb_inds.long()] - q_pts.detach().float()[:, None, :]    # [Q, nn, 3]
    n_sq = (nb * nb).sum(-1)                                               # [Q, nn]
    kp_sq = (kp * kp).sum(-1)                                              # [KP]
    cross = (nb[..., 0:1] * kp[:, 0] + nb[..., 1:2] * kp[:, 1]) + nb[..., 2:3] * kp[:, 2]
    sq_d = torch.clamp(n_sq[..., None] - 2.0 * cross + kp_sq, min=0.0)    # [Q, nn, KP]
    w = influence(sq_d, KP_extent, KP_influence)
    if aggregation_mode == "closest":
        w = w * F.one_hot(sq_d.argmin(-1), kp.shape[0]).to(w.dtype)
    elif aggregation_mode != "sum":
        raise ValueError(f"unknown aggregation {aggregation_mode!r}")
    w = w.transpose(1, 2)                                                  # [Q, KP, nn]

    neighb_x = gather_rows(x.to(compute_dtype), neighb_inds)                   # [Q, nn, Cin]
    weighted = torch.bmm(w.to(compute_dtype).float(), neighb_x.float())   # [Q, KP, Cin]
    kf, cin, cout = weights.shape
    w2 = weights.reshape(kf * cin, cout)
    if compute_dtype == torch.float32:
        out = weighted.reshape(-1, kf * cin) @ w2
    else:
        out = (weighted.reshape(-1, kf * cin).to(compute_dtype) @ w2.to(compute_dtype)).float()
    active = neighb_x.float().sum(-1) > 0.0
    denom = torch.clamp(active.sum(-1), min=1).to(out.dtype)
    return out / denom[:, None]
