"""KPFCNN: the D3Feat encoder-decoder with joint descriptor + detector head
(port of ``d3feat_tpu.models.kpfcnn``).

``make_kpfcnn_specs`` walks the architecture list as the reference
constructor does (radius doubling at strided blocks, output-dim doubling
per level, skip bookkeeping, decoder concat positions). The forward returns
L2-normalised descriptors and detection scores.

Detector head (parameter-free): with f normalised by its max,
  saliency   = softplus(f - mean of f over the level-0 neighborhood)
  channelmax = f / (1e-6 + max over channels)
  score      = max over channels of (saliency * channelmax)
The neighborhood sums and counts come from the K3 band-head kernel, or,
when conv0 has no thresholds (list mode) or on the train path with
``bandhead_train=False``, from a gather of the level-0 neighbourhoods (the
JAX package's XLA route, outside any Pallas kernel). At eval
time points that are not a per-channel local max of their neighborhood
score zero (optionally only the top-M candidates are gated,
``eval_gate_topm``), the neighbourhood max on K7 (``ops.neighbor_max``);
the training head has no gate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Tuple

import torch
from torch import nn

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.models.blocks import BlockSpec, classify_block, make_block
from d3feat_tpu_torch.models.kernel_points import load_kernels
from d3feat_tpu_torch.utils.profiling import device_tensor, span


@dataclass(frozen=True)
class KPFCNNSpecs:
    """Static model structure derived from the architecture list."""

    encoder: Tuple[BlockSpec, ...]
    decoder: Tuple[BlockSpec, ...]
    encoder_skips: Tuple[int, ...]      # encoder block indices to stash before
    decoder_concats: Tuple[int, ...]    # decoder block indices that concat a skip


def make_kpfcnn_specs(config) -> KPFCNNSpecs:
    """Walk ``config.architecture()`` the way the reference constructor does."""
    arch = config.architecture()
    layer = 0
    r = config.first_subsampling_dl * config.conv_radius
    in_dim = config.in_features_dim
    out_dim = config.first_features_dim

    encoder: List[BlockSpec] = []
    encoder_skips: List[int] = []
    encoder_skip_dims: List[int] = []
    for block_i, name in enumerate(arch):
        if any(tag in name for tag in ("pool", "strided", "upsample", "global")):
            encoder_skips.append(block_i)
            encoder_skip_dims.append(in_dim)
        if "upsample" in name:
            break
        encoder.append(BlockSpec(
            name=name, kind=classify_block(name), layer=layer,
            in_dim=in_dim, out_dim=out_dim, radius=r,
            strided="strided" in name, deformable="deform" in name))
        in_dim = out_dim // 2 if "simple" in name else out_dim
        if "pool" in name or "strided" in name:
            layer += 1
            r *= 2
            out_dim *= 2

    decoder: List[BlockSpec] = []
    decoder_concats: List[int] = []
    start_i = next(i for i, n in enumerate(arch) if "upsample" in n)
    for block_i, name in enumerate(arch[start_i:]):
        if block_i > 0 and "upsample" in arch[start_i + block_i - 1]:
            in_dim += encoder_skip_dims[layer]
            decoder_concats.append(block_i)
        decoder.append(BlockSpec(
            name=name, kind=classify_block(name), layer=layer,
            in_dim=in_dim, out_dim=out_dim, radius=r,
            strided=False, deformable="deform" in name))
        in_dim = out_dim
        if "upsample" in name:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2

    return KPFCNNSpecs(encoder=tuple(encoder), decoder=tuple(decoder),
                       encoder_skips=tuple(encoder_skips),
                       decoder_concats=tuple(decoder_concats))


class KPFCNN(nn.Module):
    """Encoder and decoder blocks; ``state_dict`` names follow the JAX
    parameter tree (``encoder.<i>.<...>``, ``decoder.<i>.<...>``)."""

    def __init__(self, config, specs: KPFCNNSpecs, generator: torch.Generator):
        super().__init__()
        self.config = config
        self.specs = specs
        unit_kp = load_kernels(1.0, config.num_kernel_points, dimension=config.in_points_dim,
                               fixed=config.fixed_kernel_points,
                               deterministic=config.deterministic_kernel_points, seed=config.seed)
        self.encoder = nn.ModuleList(
            make_block(s, config, unit_kp * s.radius, generator) for s in specs.encoder)
        self.decoder = nn.ModuleList(
            make_block(s, config, unit_kp * s.radius, generator) for s in specs.decoder)


def init_kpfcnn(config, seed: int = 0, device="cuda", specs: KPFCNNSpecs = None) -> KPFCNN:
    """A ``KPFCNN`` with random weights drawn from ``torch.Generator`` seeded
    with ``seed``, on ``device``. Every KPConv shares one unit disposition
    scaled to its radius: with ``config.deterministic_kernel_points`` off,
    randomised by ``config.seed`` (``models.kernel_points.load_kernels``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return KPFCNN(config, specs or make_kpfcnn_specs(config), gen)


class KPFCNNOutput(NamedTuple):
    features: torch.Tensor      # [C0, output_dim] L2-normalised descriptors
    scores: torch.Tensor        # [C0, 1] detection scores
    raw_features: torch.Tensor  # pre-normalisation descriptors
    auxes: tuple = ()           # the deformable convs' KPConvAux, in block order


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``, in value and in gradient
    (0.5 at 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def band_head_inputs(batch, config, impl: str = "auto") -> dict:
    """Everything the K3 call needs besides the features: conv0's search
    arguments (``models.blocks.search_inputs``: level-0 sorted query rows
    with their conv0 thresholds padded to the 256-row tile, support rows,
    tile windows, and on the kernel path conv0's lists), shared with the
    level-0 convs (keyword arguments of ``ops.head.band_head``; the convs'
    bf16 chunk rows left out)."""
    from d3feat_tpu_torch.models.blocks import search_inputs

    r0 = config.first_subsampling_dl * config.conv_radius
    args = search_inputs(batch, config, 0, False, r0, impl)
    del args["chunk"]
    return args


def gather_head_mean(f: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """[C0, D] mean of each level-0 neighbourhood's features by a gather
    (``neighbors`` [C0, K0], shadow C0 reads a zero row): the sum over the
    neighbours divided by the count of neighbours whose feature sum is not
    0, at least 1 (``d3feat_tpu/models/kpfcnn.py:220-227``)."""
    from d3feat_tpu_torch.models.kpconv import gather_rows

    nf = gather_rows(f, neighbors)                                  # [C0, K0, D]
    neighbor_num = torch.clamp((nf.sum(-1) != 0.0).sum(-1, keepdim=True), min=1).to(f.dtype)
    return nf.sum(1) / neighbor_num


def detection_scores(batch, features: torch.Tensor, *, config, train: bool = False,
                     per_cloud_norm: bool = False, impl: str = "auto") -> torch.Tensor:
    """Detector head over the sorted-space pyramid ``batch``.

    ``per_cloud_norm`` normalises each stacked cloud by its own max (the
    extraction path, where independent fragments share a batch); otherwise
    one global max, as the reference. ``train`` drops the eval local-max
    gate. Differentiable in ``features`` (the K3 sums through
    ``ops.head.BandHeadFn``, whose backward is K5; or the gather head,
    ``gather_head_mean``, as ``d3feat_tpu/models/kpfcnn.py:178-183``
    chooses it)."""
    from d3feat_tpu_torch.models.blocks import search_mode
    from d3feat_tpu_torch.ops.head import BandHeadFn
    from d3feat_tpu_torch.ops.neighbor_max import neighbor_max
    from d3feat_tpu_torch.ops.subsample import lengths_to_cloud_ids

    f = features
    lengths = batch["lengths"][0]
    num_clouds = lengths.shape[0]
    if per_cloud_norm:
        cidc = torch.clamp(lengths_to_cloud_ids(lengths, f.shape[0]), max=num_clouds - 1).long()
        rowmax = f.amax(1)
        cmax = torch.stack([
            torch.where(cidc == b, rowmax,
                        device_tensor(-torch.inf, f.device, site="const.head")).amax()
            for b in range(num_clouds)])
        f = f / (cmax[cidc, None] + 1e-6)
    else:
        f = f / (f.amax() + 1e-6)

    use_band_head = ((not train or config.bandhead_train) and 0 in (batch.get("band") or {})
                     and search_mode(batch, "conv0") == "threshold")
    if use_band_head:
        args = band_head_inputs(batch, config, impl)
        s_rows = f.shape[0]
        band_pad = args["s_rows"].shape[0] - s_rows
        x_pad = torch.cat([f.float(), f.new_zeros((band_pad, f.shape[1]))]).contiguous()
        fsum, cnt = BandHeadFn.apply(x_pad, args, impl)
        neighbor_num = torch.clamp(cnt[:s_rows, None], min=1.0)  # a count: no gradient
        mean_features = fsum[:s_rows, : f.shape[1]] / neighbor_num
    else:
        mean_features = gather_head_mean(f, batch["neighbors"][0])
    local_max_score = softplus(f - mean_features)

    depth_wise_max = f.amax(1, keepdim=True)
    depth_wise_max_score = f / (1e-6 + depth_wise_max)
    scores = (local_max_score * depth_wise_max_score).amax(1, keepdim=True)  # [C0, 1]
    if train:
        return scores

    # hard local-max gate; with eval_gate_topm > 0 only the top-M points by
    # ungated score are gated (gating only zeroes scores, so top-k keypoint
    # selection stays exact), the rest report 0
    neighbor = batch["neighbors"][0]  # [C0, K0], shadow = C0
    topm = config.eval_gate_topm
    s_flat = scores[:, 0]
    if topm and topm < f.shape[0]:
        cand = torch.topk(s_flat, topm).indices
        local_max = neighbor_max(f, neighbor[cand], impl)             # [M, D]
        det = (f[cand] == local_max).float().amax(1)
        return torch.zeros_like(s_flat).index_copy(0, cand, s_flat[cand] * det)[:, None]
    local_max = neighbor_max(f, neighbor, impl)
    detected = (f == local_max).float().amax(1, keepdim=True)
    return scores * detected


def apply_kpfcnn(model: KPFCNN, batch, *, train: bool = False, per_cloud_norm: bool = False,
                 impl: str = "auto", compute_dtype=torch.float32) -> KPFCNNOutput:
    """Forward over a sorted-space pyramid ``batch`` (with ``features`` in
    the pyramid's level-0 sorted order). With ``train`` it is the training
    forward, differentiable in the model's parameters (every band KPConv
    through ``ops.band_conv.BandConvFn``, K2 forward and K4 backward, the
    head through ``ops.head.BandHeadFn``, K3 and K5) with the training
    detector head (no local-max gate); without, the eval forward, which
    records no gradients. ``compute_dtype`` ``torch.bfloat16`` runs the
    blocks' products on bf16 operands (``models.blocks``); the head and
    the normalisation stay f32. With batch norm, ``train`` normalises by
    the batch's statistics and updates the running ones in place (the
    JAX package's ``new_state``); the eval forward reads them. The
    deformable convs' ``KPConvAux`` come back in ``auxes``."""
    with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        return _forward(model, batch, train, per_cloud_norm, impl, compute_dtype)


def _forward(model: KPFCNN, batch, train: bool, per_cloud_norm: bool, impl: str,
             compute_dtype):
    specs = model.specs
    mask0 = batch["masks"][0]
    x = batch["features"].float() * mask0[:, None]
    skips, auxes = [], []
    for i, block in enumerate(model.encoder):
        if i in specs.encoder_skips:
            skips.append(x)
        with span("model.block", ("enc", i, specs.encoder[i].name)):
            x, aux = block(x, batch, impl=impl, compute_dtype=compute_dtype, train=train)
        if aux is not None:
            auxes.append(aux)
    for i, block in enumerate(model.decoder):
        if i in specs.decoder_concats:
            x = torch.cat([x, skips.pop()], 1)
        with span("model.block", ("dec", i, specs.decoder[i].name)):
            x, aux = block(x, batch, impl=impl, compute_dtype=compute_dtype, train=train)
        if aux is not None:
            auxes.append(aux)
    x = x * mask0[:, None]
    with span("model.head"):
        scores = detection_scores(batch, x, config=model.config, train=train,
                                  per_cloud_norm=per_cloud_norm, impl=impl)
    # safe L2 normalisation: zero (padding) rows stay zero with finite
    # gradients (the reference's double-where)
    norm2 = (x * x).sum(-1, keepdim=True)
    norm2_safe = torch.where(norm2 > 0.0, norm2, 1.0)
    features = torch.where(norm2 > 0.0, x * torch.rsqrt(norm2_safe), 0.0)
    return KPFCNNOutput(features=features, scores=scores, raw_features=x, auxes=tuple(auxes))
