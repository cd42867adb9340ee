"""KPCNN: the KPConv classification network (port of
``d3feat_tpu.models.kpcnn``).

An encoder-only KPConv stack ending in ``global_average`` (one feature row
per stacked cloud), then a 1024-wide unary head and a class-logit unary;
the loss is cross entropy plus the deformable convs' fitting regularizer.
It runs on whichever pyramid the config's ``neighbor_search`` builds: on
the band route the rigid convs that ``band_conv_eligible`` admits run K2
(K4 backward), every other conv the gather or deformable KPConv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.losses.regularizers import p2p_fitting_regularizer
from d3feat_tpu_torch.models.blocks import BlockSpec, Unary, classify_block, make_block
from d3feat_tpu_torch.models.kernel_points import load_kernels

HEAD_DIM = 1024


@dataclass(frozen=True)
class KPCNNSpecs:
    blocks: Tuple[BlockSpec, ...]
    head_in_dim: int


def classification_architecture(num_layers: int) -> List[str]:
    """Encoder-only block list ending in global pooling."""
    arch = ["simple", "resnetb"]
    for _ in range(num_layers - 1):
        arch += ["resnetb_strided", "resnetb", "resnetb"]
    return arch + ["global_average"]


def make_kpcnn_specs(config, arch: Optional[List[str]] = None) -> KPCNNSpecs:
    """Walk the classification architecture (default
    ``classification_architecture(config.num_layers)``) the way the
    reference constructor does: radius and width double at each strided or
    pooling block."""
    if arch is None:
        arch = classification_architecture(config.num_layers)
    layer = 0
    r = config.first_subsampling_dl * config.conv_radius
    in_dim = config.in_features_dim
    out_dim = config.first_features_dim
    blocks: List[BlockSpec] = []
    for name in arch:
        if "upsample" in name:
            break
        blocks.append(BlockSpec(
            name=name, kind=classify_block(name), layer=layer,
            in_dim=in_dim, out_dim=out_dim, radius=r,
            strided="strided" in name, deformable="deform" in name))
        in_dim = out_dim // 2 if "simple" in name else out_dim
        if "pool" in name or "strided" in name:
            layer += 1
            r *= 2
            out_dim *= 2
    return KPCNNSpecs(blocks=tuple(blocks), head_in_dim=in_dim)


class KPCNN(nn.Module):
    """Blocks and head; ``state_dict`` names follow the JAX parameter tree
    (``blocks.<i>.<...>``, ``head_mlp.<...>``, ``head_softmax.<...>``)."""

    def __init__(self, config, specs: KPCNNSpecs, generator: torch.Generator):
        super().__init__()
        self.config = config
        self.specs = specs
        unit_kp = load_kernels(1.0, config.num_kernel_points, dimension=config.in_points_dim,
                               fixed=config.fixed_kernel_points,
                               deterministic=getattr(config, "deterministic_kernel_points",
                                                     True),
                               seed=getattr(config, "seed", 0))
        self.blocks = nn.ModuleList(
            make_block(s, config, unit_kp * s.radius, generator) for s in specs.blocks)
        self.head_mlp = Unary(specs.head_in_dim, HEAD_DIM, generator, config)
        self.head_softmax = Unary(HEAD_DIM, config.num_classes, generator, config)


def init_kpcnn(config, seed: int = 0, device="cuda", specs: KPCNNSpecs = None) -> KPCNN:
    """A ``KPCNN`` with random weights drawn from ``torch.Generator`` seeded
    with ``seed``, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return KPCNN(config, specs or make_kpcnn_specs(config), gen)


class KPCNNOutput(NamedTuple):
    logits: torch.Tensor  # [B, num_classes], one row per stacked cloud
    auxes: tuple          # the deformable convs' KPConvAux, in block order


def apply_kpcnn(model: KPCNN, batch, *, train: bool = False, impl: str = "auto",
                compute_dtype=torch.float32) -> KPCNNOutput:
    """Forward over a pyramid ``batch`` with its ``features`` (in the
    pyramid's row order: level 0's sorted order on the band route). With
    ``train`` it is differentiable in the parameters and batch norm uses
    (and updates) the batch's statistics, as ``apply_kpfcnn``."""
    with torch.set_grad_enabled(train and torch.is_grad_enabled()):
        x = batch["features"].float() * batch["masks"][0][:, None]
        auxes = []
        for block in model.blocks:
            x, aux = block(x, batch, impl=impl, compute_dtype=compute_dtype, train=train)
            if aux is not None:
                auxes.append(aux)
        ones = torch.ones(batch["lengths"][-1].shape[0], dtype=torch.bool, device=x.device)
        x = model.head_mlp(x, ones, compute_dtype=compute_dtype, train=train)
        x = model.head_softmax(x, ones, relu=False, compute_dtype=compute_dtype, train=train)
    return KPCNNOutput(logits=x, auxes=tuple(auxes))


def kpcnn_loss(logits: torch.Tensor, labels: torch.Tensor, auxes, config):
    """(cross entropy + the deformable regularizer, cross entropy)."""
    logp = torch.log_softmax(logits, -1)
    ce = -logp.gather(1, labels.long()[:, None]).mean()
    reg = 0.0
    if auxes:
        reg = p2p_fitting_regularizer(
            auxes, KP_extent=config.KP_extent,
            repulse_extent=getattr(config, "repulse_extent", 1.2),
            deform_fitting_power=getattr(config, "deform_fitting_power", 1.0))
    return ce + reg, ce


def kpcnn_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of correct argmax predictions."""
    return (logits.argmax(-1) == labels.long()).float().mean()
