"""Network blocks (port of ``d3feat_tpu.models.blocks``): unary and
last_unary, simple and resnet-bottleneck KPConv blocks (plain and strided,
rigid and deformable), nearest-upsample, max-pool and global-average; the
two rigid KPConvs, the band KPConv (K2 forward, K4 backward) where
``band_conv_eligible`` holds and the gather KPConv
(``models.kpconv.kpconv``) everywhere else; and the deformable KPConv
(``models.kpconv.deformable_kpconv``), whose neighbour sums run on K6
where no gradient is needed and by the gather route otherwise. The max
pools take their neighbourhood max on K7 (``ops.neighbor_max``) where no
gradient is needed and by a gather otherwise.

Modules carry the JAX package's parameter names, so a parameter's
``state_dict`` name is its JAX key path written with dots
(``encoder.1.unary1.linear.w``). Linear weights are stored ``[in, out]``.
Pooling reads the shadow index as a zero feature row, so all-shadow
neighborhoods pool to zero. With ``use_batch_norm`` each norm is a masked
batch norm (``BatchNorm``) whose running ``mean`` and ``var`` are buffers
(the JAX package's model state), else a learned bias (``Norm``).

Every block's forward takes ``compute_dtype`` (``torch.float32`` or
``torch.bfloat16``, the model config's ``compute_dtype``): in bf16 the
linear layers multiply bf16 operands and the band KPConvs run bf16
panels (the gather KPConvs bf16 operands), as the JAX package's blocks
do; everything else stays f32. It takes ``train`` (batch norm from the
batch's statistics, updating the running ones, as JAX's ``train=True``)
and returns ``(features, aux)``, ``aux`` the ``KPConvAux`` of a
deformable conv, else None.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from d3feat_tpu_torch.models.kpconv import (KPConv, deformable_kpconv, gather_rows, kpconv,
                                            torch_kaiming_uniform)

LEAKY_SLOPE = 0.1


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``, so the
    gradient at exactly 0 is 1 (``F.leaky_relu`` gives the slope there)."""
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


@dataclass(frozen=True)
class BlockSpec:
    """Static description of one network block."""

    name: str         # architecture entry, e.g. 'resnetb_strided'
    kind: str         # 'unary' | 'last_unary' | 'simple' | 'resnetb' | 'nearest_upsample'
    #                 | 'max_pool' | 'global_average'
    layer: int        # pyramid level index
    in_dim: int
    out_dim: int
    radius: float     # conv radius at this level
    strided: bool = False
    deformable: bool = False


def classify_block(name: str) -> str:
    if name == "unary":
        return "unary"
    if name == "last_unary":
        return "last_unary"
    if name.startswith("simple"):
        return "simple"
    if name.startswith("resnetb"):
        return "resnetb"
    if name == "nearest_upsample":
        return "nearest_upsample"
    if name in ("max_pool", "max_pool_wide"):
        return "max_pool"
    if name == "global_average":
        return "global_average"
    raise ValueError(f"unknown block name {name!r}")


def closest_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Features of the nearest (first) neighbor; shadow -> zeros."""
    return gather_rows(x, inds[:, 0])


def max_pool(x: torch.Tensor, inds: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Max over each neighborhood with a zero shadow row
    (``ops.neighbor_max.neighbor_max``)."""
    from d3feat_tpu_torch.ops.neighbor_max import neighbor_max

    return neighbor_max(x, inds, impl)


def global_average(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[B, D] masked per-cloud mean of the stacked rows ``x`` (clouds
    contiguous, padding rows after them), B = ``len(lengths)``."""
    from d3feat_tpu_torch.ops.subsample import lengths_to_cloud_ids

    b = lengths.shape[0]
    cid = lengths_to_cloud_ids(lengths, x.shape[0]).long()
    rows = torch.where((cid < b)[:, None], x, 0.0)
    sums = x.new_zeros((b, x.shape[1])).index_add(0, torch.clamp(cid, max=b - 1), rows)
    return sums / torch.clamp(lengths[:, None].to(x.dtype), min=1.0)


class Linear(nn.Module):
    """``x @ w + b`` with torch ``nn.Linear``'s default init, ``w`` [in, out].
    In bf16 the product of the bf16 operands is itself bf16 (f32
    accumulation rounded once), then widened before the bias, as JAX's
    ``apply_linear`` computes ``bf16 @ bf16``."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch_kaiming_uniform((out_dim, in_dim), generator).T.contiguous())
        bound = 1.0 / math.sqrt(in_dim)
        u = torch.rand((out_dim,), generator=generator, device=generator.device)
        self.b = nn.Parameter((u * 2.0 - 1.0) * bound)

    def forward(self, x, compute_dtype=torch.float32):
        if compute_dtype == torch.float32:
            return x @ self.w + self.b
        return (x.to(compute_dtype) @ self.w.to(compute_dtype)).float() + self.b


class Norm(nn.Module):
    """The learned bias that replaces batch norm (``use_batch_norm=False``)."""

    def __init__(self, dim: int, device):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, mask=None, train: bool = False):
        return x + self.bias


class BatchNorm(nn.Module):
    """Masked batch norm (``use_batch_norm=True``; JAX's ``apply_norm``):
    parameters ``scale`` and ``offset``, running ``mean`` and ``var`` as
    buffers. With ``train`` the statistics come from the rows ``mask``
    marks valid (n of them, at least 1; the variance divided by n) and the
    running ones move by ``momentum`` (torch's convention, ``running <- (1 -
    m) running + m batch``), the variance's with the ``n / max(n - 1, 1)``
    correction; otherwise the running statistics normalise. Then
    ``(x - mean) rsqrt(var + 1e-5) scale + offset``."""

    def __init__(self, dim: int, momentum: float, device):
        super().__init__()
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.offset = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("mean", torch.zeros(dim, device=device))
        self.register_buffer("var", torch.ones(dim, device=device))

    def forward(self, x, mask=None, train: bool = False):
        if train:
            w = mask.to(x.dtype)[:, None]
            n = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(0) / n
            var = (w * (x - mean) ** 2).sum(0) / n
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var
                               + m * var * (n / torch.clamp(n - 1.0, min=1.0)))
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.scale + self.offset


def make_norm(dim: int, config, device) -> nn.Module:
    """``BatchNorm`` under ``config.use_batch_norm``, else ``Norm``."""
    if config.use_batch_norm:
        return BatchNorm(dim, config.batch_norm_momentum, device)
    return Norm(dim, device)


class Unary(nn.Module):
    """Linear + norm + optional LeakyReLU(0.1); the norm runs on the f32
    output of the linear layer in either compute dtype."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator, config):
        super().__init__()
        self.linear = Linear(in_dim, out_dim, generator)
        self.norm = make_norm(out_dim, config, generator.device)

    def forward(self, x, mask=None, relu: bool = True, compute_dtype=torch.float32,
                train: bool = False):
        y = self.norm(self.linear(x, compute_dtype), mask, train)
        return leaky_relu(y) if relu else y


# ---------------------------------------------------------------------------
# K2 band KPConv
# ---------------------------------------------------------------------------


def band_conv_eligible(spec: BlockSpec, batch, config) -> bool:
    """Whether the band kernel covers this block: rigid, linear influence,
    sum aggregation, weight panel within ``bandconv_max_panel_mb`` (sized
    as the reference sizes it), unscaled search radius and band state
    present, as ``d3feat_tpu/models/blocks.py::band_conv_eligible`` decides.
    A level whose neighbour cap a deformable conv widened keeps its rigid
    convs here: the lists take up to 256 rows a query
    (``ops.band_lists.list_width``)."""
    from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec

    if spec.deformable:
        return False
    if config.KP_influence != "linear" or config.aggregation_mode != "sum":
        return False
    cin = spec.in_dim if spec.kind == "simple" else spec.out_dim // 4
    cout = spec.out_dim // 2 if spec.kind == "simple" else spec.out_dim // 4
    cin_p = -(-cin // 128) * 128
    panel_mb = config.num_kernel_points * cin_p * cout * 4 / (1024 * 1024)
    if panel_mb > config.bandconv_max_panel_mb:
        return False
    if spec.layer > config.bandconv_max_layer:
        return False
    pyr = make_pyramid_spec(config)
    scale = pyr.pool_r_scale if spec.strided else pyr.conv_r_scale
    if spec.layer < len(scale) and scale[spec.layer] != 1.0:
        return False
    band = batch.get("band") or {}
    q_level = spec.layer + 1 if spec.strided else spec.layer
    return spec.layer in band and q_level in band


def band_query_tiles(qb, sb, num_clouds: int, r: float, tile: int, s_rows: int,
                     thr, ptie):
    """Shared band-kernel query prep: pad the sorted query rows and their
    thresholds (when given) to a tile multiple and compute each tile's
    support window ``[start, end)`` from the sorted keys (``r + EPS``
    margin).

    Returns (q_rows [Nq_pad, 4], starts, ends, thr, ptie)."""
    from d3feat_tpu_torch.ops.neighbors import SortedLevel, pad_query_rows, tile_key_bounds

    nq = qb["q_rows"].shape[0]
    pad = (-nq) % tile
    q_rows = pad_query_rows(qb["q_rows"], tile)
    if pad and thr is not None:
        thr = torch.cat([thr, thr.new_zeros(pad)])
        ptie = torch.cat([ptie, ptie.new_full((pad,), -1.0)])
    kmin, kmax = tile_key_bounds(qb["key_sorted"], tile, num_clouds)
    margin = r + SortedLevel.EPS  # python float, rounded once to float32 below
    starts = torch.clamp(torch.searchsorted(sb["key_sorted"], kmin - margin), max=s_rows)
    ends = torch.searchsorted(sb["key_sorted"], kmax + margin)
    return q_rows, starts, ends, thr, ptie


def search_mode(batch, name: str) -> str:
    """``"threshold"`` when the pyramid kept the search's thresholds
    (``batch["sel_thr"][name]``), else ``"list"``: the band kernels then
    select from the search's own position lists, as the JAX package falls
    back to ``(None, None)`` (``d3feat_tpu/models/blocks.py:462``)."""
    return "threshold" if name in (batch.get("sel_thr") or {}) else "list"


def search_inputs(batch, config, layer: int, strided: bool, radius: float,
                  impl: str = "auto") -> dict:
    """The band kernels' arguments of one search (``conv{layer}``, or
    ``pool{layer}`` when ``strided``): sorted query rows padded to the
    tile, with their thresholds (threshold mode) or ``thr``/``ptie`` None
    and the search's position lists ``neighb`` [K, Nq_pad] int32, padded
    queries listing the shadow (list mode, ``search_mode``), support rows,
    tile windows, tile and the windows' chunk rows (keyword arguments of
    ``ops.band_conv.band_conv`` besides the features, weights and extent),
    and on the kernel path the search's ``lists`` of that mode. Built once
    and kept in ``batch["band_args"]`` under the search's name
    (``"<name>:list"`` in list mode, so one batch holds both modes), so
    every conv of the search, and the head for ``conv0``, share them."""
    from d3feat_tpu_torch.ops.band_lists import band_lists, band_lists_given
    from d3feat_tpu_torch.ops.build import uses_kernel
    from d3feat_tpu_torch.ops.neighbors import band_windows, pick_chunk
    from d3feat_tpu_torch.ops.pyramid import level_band_cap

    name = f"pool{layer}" if strided else f"conv{layer}"
    mode = search_mode(batch, name)
    key = name if mode == "threshold" else f"{name}:list"
    memo = batch.setdefault("band_args", {})
    args = memo.get(key)
    if args is None:
        q_level = layer + 1 if strided else layer
        qb, sb = batch["band"][q_level], batch["band"][layer]
        thr, ptie = batch["sel_thr"][name] if mode == "threshold" else (None, None)
        s_rows = batch["points"][layer].shape[0]
        n_q_rows = batch["points"][q_level].shape[0]
        # strided blocks carry the wide pool band: the smaller tile keeps the
        # window per tile bounded (same sizing as the pyramid's pool search)
        tile = 128 if strided else 256
        num_clouds = len(batch["lengths"][0])
        q_rows, starts, ends, thr, ptie = band_query_tiles(
            qb, sb, num_clouds, radius, tile, s_rows, thr, ptie)
        band_cap = level_band_cap(s_rows, num_clouds, config.band_frac,
                                  tile=tile, ratio=-(-s_rows // n_q_rows))
        starts, wends = band_windows(starts, ends, band_cap)
        args = dict(q_rows=q_rows.contiguous(), thr=thr, ptie=ptie, s_rows=sb["s_rows"],
                    starts=starts, wends=wends, query_tile=tile, chunk=pick_chunk(band_cap))
        if mode == "threshold":
            args.update(thr=thr.contiguous(), ptie=ptie.contiguous())
        else:  # the padded queries list the shadow (d3feat_tpu/models/blocks.py:480-483)
            lists = batch["pools" if strided else "neighbors"][layer]
            pad = q_rows.shape[0] - lists.shape[0]
            args["neighb"] = torch.cat([lists.T.to(torch.int32),
                                        lists.new_full((lists.shape[1], pad), s_rows,
                                                       dtype=torch.int32)], 1).contiguous()
        memo[key] = args
    if "lists" not in args and uses_kernel(impl, args["q_rows"]):
        kw = {k: args[k] for k in ("starts", "wends", "query_tile")}
        if mode == "threshold":
            cap = batch["pools" if strided else "neighbors"][layer].shape[1]
            args["lists"] = band_lists(args["q_rows"], args["thr"], args["ptie"],
                                       args["s_rows"], width=cap, impl=impl, **kw)
        else:
            args["lists"] = band_lists_given(args["neighb"], n_rows=batch["points"][layer].shape[0],
                                             impl=impl, **kw)
    return dict(args)


def band_conv_inputs(spec: BlockSpec, batch, config, impl: str = "auto") -> dict:
    """Everything the K2 call of one block needs besides its features and
    weights: its search's ``search_inputs`` and the kernel extent."""
    args = search_inputs(batch, config, spec.layer, spec.strided, spec.radius, impl)
    return dict(args, extent=spec.radius * config.KP_extent / config.conv_radius)


def apply_band_kpconv(conv: KPConv, spec: BlockSpec, x: torch.Tensor, batch, config,
                      impl: str = "auto", compute_dtype=torch.float32) -> torch.Tensor:
    """Rigid KPConv of one block through the K2 band kernel (K4 in the
    backward), in the pyramid's sorted space (features, points and lists
    already sorted), on bf16 panels when ``compute_dtype`` is bf16.
    Differentiable in ``x`` and the conv weights."""
    from d3feat_tpu_torch.ops.band_conv import BandConvFn

    panel = "bfloat16" if compute_dtype == torch.bfloat16 else "float32"
    args = dict(band_conv_inputs(spec, batch, config, impl), panel_dtype=panel)
    band_pad = args["s_rows"].shape[0] - x.shape[0]
    x_sorted = torch.cat([x, x.new_zeros((band_pad, x.shape[1]))]).float().contiguous()
    out = BandConvFn.apply(x_sorted, conv.weights.contiguous(),
                           conv.kernel_points.contiguous(), args, impl)
    n_q_rows = batch["points"][spec.layer + 1 if spec.strided else spec.layer].shape[0]
    return out[:n_q_rows]


def apply_gather_kpconv(conv: KPConv, spec: BlockSpec, x: torch.Tensor, batch, config,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Rigid KPConv of one block through the gather KPConv
    (``models.kpconv.kpconv``), for the blocks the band kernels do not
    cover (``band_conv_eligible``): on the original-order pyramid with its
    original indices, or on the band pyramid with its sorted points and
    positions (the mixed route)."""
    l = spec.layer
    q_level = l + 1 if spec.strided else l
    inds = batch["pools"][l] if spec.strided else batch["neighbors"][l]
    return kpconv(batch["points"][q_level], batch["points"][l], inds, x, conv.weights,
                  conv.kernel_points, KP_extent=spec.radius * config.KP_extent / config.conv_radius,
                  KP_influence=config.KP_influence, aggregation_mode=config.aggregation_mode,
                  compute_dtype=compute_dtype)


def apply_deformable_kpconv(conv: KPConv, spec: BlockSpec, x: torch.Tensor, batch, config,
                            impl: str = "auto", compute_dtype=torch.float32):
    """Deformable KPConv of one block (``models.kpconv.deformable_kpconv``)
    on either pyramid, with the block's points and lists as
    ``apply_gather_kpconv`` reads them; its neighbour sums on K6 or by the
    gather route as ``impl`` and the need for a gradient say
    (``ops.deform_conv.deform_sums``). Returns (features, KPConvAux)."""
    l = spec.layer
    q_level = l + 1 if spec.strided else l
    inds = batch["pools"][l] if spec.strided else batch["neighbors"][l]
    return deformable_kpconv(batch["points"][q_level], batch["points"][l], inds, x, conv,
                             KP_extent=spec.radius * config.KP_extent / config.conv_radius,
                             KP_influence=config.KP_influence,
                             aggregation_mode=config.aggregation_mode,
                             compute_dtype=compute_dtype, impl=impl)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


class _ConvBlock(nn.Module):
    def __init__(self, spec: BlockSpec, config):
        super().__init__()
        self.spec = spec
        self.config = config

    def _conv(self, x, batch, impl, compute_dtype):
        if self.spec.deformable:
            return apply_deformable_kpconv(self.conv, self.spec, x, batch, self.config, impl,
                                           compute_dtype)
        if band_conv_eligible(self.spec, batch, self.config):
            return apply_band_kpconv(self.conv, self.spec, x, batch, self.config, impl,
                                     compute_dtype), None
        return apply_gather_kpconv(self.conv, self.spec, x, batch, self.config,
                                   compute_dtype), None

    def _out_mask(self, batch):
        return batch["masks"][self.spec.layer + 1 if self.spec.strided else self.spec.layer]


class SimpleBlock(_ConvBlock):
    def __init__(self, spec, config, kernel_points, generator):
        super().__init__(spec, config)
        self.conv = KPConv(kernel_points, spec.in_dim, spec.out_dim // 2, generator,
                           deformable=spec.deformable, modulated=config.modulated)
        self.norm = make_norm(spec.out_dim // 2, config, generator.device)

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        y, aux = self._conv(x, batch, impl, compute_dtype)
        return leaky_relu(self.norm(y, self._out_mask(batch), train)), aux


class ResnetBBlock(_ConvBlock):
    def __init__(self, spec, config, kernel_points, generator):
        super().__init__(spec, config)
        mid = spec.out_dim // 4
        if spec.in_dim != mid:
            self.unary1 = Unary(spec.in_dim, mid, generator, config)
        self.conv = KPConv(kernel_points, mid, mid, generator, deformable=spec.deformable,
                           modulated=config.modulated)
        self.norm_conv = make_norm(mid, config, generator.device)
        self.unary2 = Unary(mid, spec.out_dim, generator, config)
        if spec.in_dim != spec.out_dim:
            self.shortcut = Unary(spec.in_dim, spec.out_dim, generator, config)

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        spec, cd = self.spec, compute_dtype
        out_mask = self._out_mask(batch)
        h = x
        if hasattr(self, "unary1"):
            h = self.unary1(x, batch["masks"][spec.layer], compute_dtype=cd, train=train)
        h, aux = self._conv(h, batch, impl, cd)
        h = leaky_relu(self.norm_conv(h, out_mask, train))
        h = self.unary2(h, out_mask, relu=False, compute_dtype=cd, train=train)
        shortcut = max_pool(x, batch["pools"][spec.layer], impl) if spec.strided else x
        if hasattr(self, "shortcut"):
            shortcut = self.shortcut(shortcut, out_mask, relu=False, compute_dtype=cd,
                                     train=train)
        return leaky_relu(h + shortcut), aux


class UnaryBlock(Unary):
    def __init__(self, spec, config, generator):
        super().__init__(spec.in_dim, spec.out_dim, generator, config)
        self.spec = spec

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        return super().forward(x, batch["masks"][self.spec.layer], relu=True,
                               compute_dtype=compute_dtype, train=train), None


class LastUnaryBlock(nn.Module):
    def __init__(self, spec, config, generator):
        super().__init__()
        self.spec = spec
        self.linear = Linear(spec.in_dim, config.output_dim, generator)

    def forward(self, x, batch=None, impl="auto", compute_dtype=torch.float32, train=False):
        return self.linear(x, compute_dtype), None


class NearestUpsampleBlock(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.spec = spec

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        # decoder block at level l pools from level l + 1 via upsamples[l - 1]
        return closest_pool(x, batch["upsamples"][self.spec.layer - 1]), None


class MaxPoolBlock(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.spec = spec

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        # the lists of pools[layer + 1], as d3feat_tpu/models/blocks.py:258-259 reads them
        return max_pool(x, batch["pools"][self.spec.layer + 1], impl), None


class GlobalAverageBlock(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.spec = spec

    def forward(self, x, batch, impl="auto", compute_dtype=torch.float32, train=False):
        return global_average(x, batch["lengths"][-1]), None


def make_block(spec: BlockSpec, config, kernel_points, generator: torch.Generator) -> nn.Module:
    """The module of one block with freshly initialised parameters."""
    kind = spec.kind
    if kind == "unary":
        return UnaryBlock(spec, config, generator)
    if kind == "last_unary":
        return LastUnaryBlock(spec, config, generator)
    if kind == "nearest_upsample":
        return NearestUpsampleBlock(spec)
    if kind == "max_pool":
        return MaxPoolBlock(spec)
    if kind == "global_average":
        return GlobalAverageBlock(spec)
    if kind == "simple":
        return SimpleBlock(spec, config, kernel_points, generator)
    if kind == "resnetb":
        return ResnetBBlock(spec, config, kernel_points, generator)
    raise ValueError(f"unknown block kind {kind!r}")
