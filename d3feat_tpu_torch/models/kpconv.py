"""KPConv (port of ``d3feat_tpu.models.kpconv``): its parameters, the
gather KPConv and the deformable KPConv.

A rigid KPConv holds ``weights`` [KP, Cin, Cout] and the fixed
``kernel_points`` [KP, 3] (a buffer without gradient; the optimizer still
decays and traces it, as the JAX package's optimizer does the parameter
leaf it keeps there). A block whose conv the band kernels cover runs K2
forward and K4 backward (``models.blocks.apply_band_kpconv``); every other
rigid KPConv runs ``kpconv`` here, the reference's gather formulation in
PyTorch ops: any influence (``constant``, ``linear``, ``gaussian``) and
aggregation (``sum``, ``closest``), on any pyramid (original indices or
sorted positions: it only reads the points and lists it is given),
differentiable by autograd in the features and the weights.

A deformable KPConv also holds ``offset_weights`` [KP, Cin, offset_dim],
``offset_bias`` [offset_dim] and the fixed ``offset_kernel_points``
(offset_dim 3 KP, or 4 KP when modulated). ``deformable_kpconv`` predicts
per-query kernel-point offsets (and, modulated, per-kernel-point weights)
with a rigid gather KPConv on the same neighbours, then convolves with the
deformed kernel points. The JAX package keeps it in XLA, so it has no band
kernel; its two neighbour sums run on K6 (``ops/deform_conv.py``) where no
gradient is needed, and by the gather route otherwise. Neighbours out of
range of every deformed kernel point are masked to the shadow row (the
reference prunes them with a top-k; same result, static shape), and the
forward returns ``KPConvAux`` for the fitting regularizer
(``losses.regularizers``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3feat_tpu_torch.ops.deform_conv import deform_sums, deform_sums_plain
from d3feat_tpu_torch.utils.profiling import span

SHADOW_COORD = 1.0e6


def torch_kaiming_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """U(-b, b), b = sqrt(3) * sqrt(2 / 6) / sqrt(fan_in), fan_in computed
    the torch way (dim 1 x trailing dims) — the reference's statistics."""
    fan_in = shape[1] if len(shape) == 2 else shape[1] * math.prod(shape[2:])
    bound = math.sqrt(3.0) * math.sqrt(2.0 / 6.0) / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * 2.0 - 1.0) * bound


class KPConv(nn.Module):
    """Kernel-point convolution parameters, rigid or (``deformable``)
    with the offset KPConv's, whose output has 3 KP columns of offsets, or
    4 KP with the modulations (``modulated``). Draws ``weights``, then
    ``offset_weights``, from ``generator``."""

    def __init__(self, kernel_points: np.ndarray, in_dim: int, out_dim: int,
                 generator: torch.Generator, deformable: bool = False,
                 modulated: bool = False):
        super().__init__()
        kp = torch.as_tensor(kernel_points, dtype=torch.float32).to(generator.device)
        k, p_dim = kp.shape
        self.deformable, self.modulated = deformable, modulated
        self.weights = nn.Parameter(torch_kaiming_uniform((k, in_dim, out_dim), generator))
        self.register_buffer("kernel_points", kp)
        if deformable:
            offset_dim = (p_dim + 1) * k if modulated else p_dim * k
            self.offset_weights = nn.Parameter(
                torch_kaiming_uniform((k, in_dim, offset_dim), generator))
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim, device=kp.device))
            self.register_buffer("offset_kernel_points", kp.clone())


class KPConvAux(NamedTuple):
    """A deformable KPConv's inputs to the fitting regularizer."""

    min_d2: torch.Tensor       # [Q, KP] least squared distance of each deformed point
    deformed_kp: torch.Tensor  # [Q, KP, 3] deformed kernel points, centred on the query


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
    whose compute-dtype feature sum is > 0, at least 1. The neighbour sums
    are ``ops/deform_conv.py::deform_sums_plain`` on shared kernel points."""
    weighted, density, _ = deform_sums_plain(
        q_pts, s_pts, neighb_inds, x, kernel_points, extent=KP_extent, drop=False,
        influence=KP_influence, aggregation=aggregation_mode, compute_dtype=compute_dtype)
    return contract(weighted, weights, density, compute_dtype)


def contract(weighted: torch.Tensor, weights: torch.Tensor, density: torch.Tensor,
             compute_dtype) -> torch.Tensor:
    """A gather KPConv's second product and density: ``weighted`` [Q, KP,
    Cin] against ``weights`` [KP, Cin, Cout] (the bf16 product rounded to
    bf16), divided by ``density`` [Q] float32 (the count of neighbours whose
    features sum to > 0, at least 1)."""
    kf, cin, cout = weights.shape
    w2 = weights.reshape(kf * cin, cout)
    if compute_dtype == torch.float32:
        out = weighted.reshape(-1, kf * cin) @ w2
    else:
        out = (weighted.reshape(-1, kf * cin).to(compute_dtype) @ w2.to(compute_dtype)).float()
    return out / density[:, None]


def deformable_kpconv(q_pts: torch.Tensor, s_pts: torch.Tensor, neighb_inds: torch.Tensor,
                      x: torch.Tensor, conv: KPConv, *, KP_extent: float,
                      KP_influence: str = "linear", aggregation_mode: str = "sum",
                      compute_dtype=torch.float32, impl: str = "auto"):
    """Deformable KPConv (the deformable branch of
    ``d3feat_tpu/models/kpconv.py::kpconv``): ``([Q, Cout] float32,
    KPConvAux)``, arguments as ``kpconv``'s.

    The offsets are the rigid gather KPConv of ``conv.offset_weights`` on
    ``conv.offset_kernel_points`` plus ``conv.offset_bias``; modulated, the
    last KP columns give ``2 sigmoid`` weights per kernel point. The
    deformed points are ``offsets * KP_extent + kernel_points``; squared
    distances are taken directly (differences, then the sum of squares),
    ``min_d2`` over every neighbour, the shadow row included. A neighbour
    within ``KP_extent`` of no deformed point is replaced by the shadow
    before the features are gathered, so it neither adds to the sums nor
    counts in the density. Gradients reach the features, ``weights``,
    ``offset_weights`` and ``offset_bias``, never the kernel points.

    Both neighbour sums go through ``ops/deform_conv.py::deform_sums``:
    with ``impl="auto"`` on K6 where no gradient is needed (extraction,
    evaluation) at linear influence, sum aggregation and float32, else by
    the gather route, its twin. Spans: ``deform.offsets`` (the offset
    KPConv and the moved kernel points), ``deform.sums`` (the deformed
    sums), ``deform.contract`` (the modulations, the product with the
    weights and the density)."""
    kw = dict(extent=KP_extent, influence=KP_influence, aggregation=aggregation_mode,
              compute_dtype=compute_dtype, impl=impl)
    kp = conv.kernel_points.detach().float()
    k, p_dim = kp.shape
    with span("deform.offsets"):
        weighted, density, _ = deform_sums(q_pts, s_pts, neighb_inds, x,
                                           conv.offset_kernel_points, drop=False, **kw)
        off = contract(weighted, conv.offset_weights, density, compute_dtype) + conv.offset_bias
        if conv.modulated:
            unscaled = off[:, :p_dim * k].reshape(-1, k, p_dim)
            modulations = 2.0 * torch.sigmoid(off[:, p_dim * k:])              # [Q, KP]
        else:
            unscaled = off.reshape(-1, k, p_dim)
            modulations = None
        deformed_kp = unscaled * KP_extent + kp                                 # [Q, KP, 3]
    with span("deform.sums"):
        weighted, density, min_d2 = deform_sums(q_pts, s_pts, neighb_inds, x, deformed_kp,
                                                drop=True, **kw)
    with span("deform.contract"):
        if modulations is not None:
            weighted = weighted * modulations[:, :, None]
        out = contract(weighted, conv.weights, density, compute_dtype)  # density on f32 features
    return out, KPConvAux(min_d2=min_d2, deformed_kp=deformed_kp)
