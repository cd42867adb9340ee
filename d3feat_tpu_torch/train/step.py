"""Training, validation and feature-extraction steps (port of
``d3feat_tpu.train.step``).

A train step takes one raw packed pair (points, features, lengths,
correspondences) and does: pyramid -> KPFCNN training forward ->
correspondence gather -> descriptor loss (circle | contrastive) + detector
loss -> backward (K4 and K5 through the band autograd functions) ->
non-finite skip -> SGD/Adam update at ``learning_rate(epoch)``.

On the band route (``neighbor_search='pallas'``) the network runs in the
pyramid's sorted row order: features are permuted by ``order0``, and the
correspondences are remapped through ``inv0``, anchors indexing cloud 0
and positives cloud 1 (offset by ``lengths[0]``). On the original-order
route (``'banded'``, ``'brute'``, ``'grid'``) it runs in the caller's row
order, with the gather KPConv and the gather head.
A model with deformable convs adds their fitting regularizer
(``losses.regularizers``) to the loss. With batch norm the train step
normalises by the batch's statistics and updates the running ones once per
step; the eval and extraction steps read them.
When any gradient is not finite no update is made: parameters, optimizer
state and the step count stay as they were (``skipped`` = 1); the batch
norm's running statistics keep that step's update, as the JAX step's
``model_state`` does.

With a process ``group`` (data parallelism, ``d3feat_tpu_torch.parallel``;
the counterpart of the JAX step's ``axis_name``) every rank runs the step
on its own pair: the gradients and the loss metrics travel in one flat
buffer through one all-reduce (sum, then divided by the world size, as
``jax.lax.pmean``), the overflow flag as their max, and the non-finite
skip is decided on the reduced gradients, so every rank applies the same
update or skips with the others.

The extraction step returns descriptors and scores in the caller's row
order, plus the overflow flag (a level exceeded its point or neighbor
capacity, so lists were truncated and the outputs are degraded — callers
must surface it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist

from d3feat_tpu_torch.losses.descriptor import circle_loss, contrastive_loss
from d3feat_tpu_torch.losses.detector import det_loss
from d3feat_tpu_torch.losses.regularizers import p2p_fitting_regularizer
from d3feat_tpu_torch.models.kpfcnn import KPFCNN, apply_kpfcnn
from d3feat_tpu_torch.ops.neighbors import permute_rows
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.train.optim import learning_rate, optimizer_step, train_tensors


@dataclass
class TrainState:
    """The model, its optimizer (``train.optim.make_optimizer``) and the
    count of completed updates."""

    model: KPFCNN
    optimizer: torch.optim.Optimizer
    step: int = 0


class StepMetrics(NamedTuple):
    loss: float
    desc_loss: float
    det_loss: float
    accuracy: float
    d_pos: float
    d_neg: float
    lr: float
    skipped: float   # 1.0 when the update was dropped (non-finite gradients)
    overflow: float  # 1.0 when a pyramid level overflowed its capacity


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(config) -> torch.dtype:
    """The config's ``compute_dtype`` as a torch dtype."""
    if config.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype: {config.compute_dtype!r}")
    return _COMPUTE_DTYPES[config.compute_dtype]


def sorted_order(pyr):
    """``(order0, inv0)`` of a band-route pyramid, whose network runs in
    level 0's sorted row order; ``(None, None)`` on the original-order
    route (``band`` empty), which runs in the caller's row order."""
    if not pyr["band"]:
        return None, None
    return pyr["band"][0]["order"], pyr["band"][0]["inv"]


def _forward_losses(model, batch, config, pyramid_spec, *, train: bool, impl: str,
                    pyramid=None):
    """Pyramid (or the given ``pyramid``) + forward + losses.
    Returns (loss, [desc_loss, det_loss, accuracy, d_pos, d_neg, overflow])."""
    pyr = pyramid if pyramid is not None else build_pyramid(
        batch["points"], batch["lengths"], spec=pyramid_spec, impl=impl)
    order0, inv0 = sorted_order(pyr)
    full = dict(pyr, features=batch["features"] if order0 is None
                else permute_rows(batch["features"], order0))
    out = apply_kpfcnn(model, full, train=train, impl=impl, compute_dtype=_compute_dtype(config))

    corr = batch["corr"].long()
    anc_idx = corr[:, 0]
    pos_idx = corr[:, 1] + batch["lengths"][0].long()
    if inv0 is not None:  # original stacked rows -> sorted rows
        anc_idx, pos_idx = inv0[anc_idx], inv0[pos_idx]
    valid = batch["corr_valid"].bool()
    anc_f, pos_f = out.features[anc_idx], out.features[pos_idx]
    anc_s, pos_s = out.scores[anc_idx], out.scores[pos_idx]
    if config.desc_loss == "circle":
        desc = circle_loss(anc_f, pos_f, batch["dist_keypts"], valid,
                           dist_type=config.dist_type, log_scale=config.log_scale,
                           safe_radius=config.safe_radius, pos_margin=config.pos_margin,
                           neg_margin=config.neg_margin)
    else:
        desc = contrastive_loss(anc_f, pos_f, batch["dist_keypts"], valid,
                                metric=config.dist_type, pos_margin=config.pos_margin,
                                neg_margin=config.neg_margin, safe_radius=config.safe_radius)
    dl = det_loss(desc.dists, anc_s, pos_s, valid)
    loss = config.desc_loss_weight * desc.loss + config.det_loss_weight * dl
    if out.auxes:
        loss = loss + p2p_fitting_regularizer(out.auxes, KP_extent=config.KP_extent)
    overflow = pyr["overflow"].float()
    return loss, [desc.loss, dl, desc.accuracy, desc.d_pos, desc.d_neg, overflow]


def reduce_mean(tensors, extra, group):
    """All-reduce ``tensors`` and the 1-D ``extra`` in one flat buffer
    (sum, then divided by the group's size), writing the means back into
    ``tensors``; returns the mean of ``extra``."""
    flat = torch.cat([t.reshape(-1) for t in tensors] + [extra.reshape(-1)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return flat[at:]


def make_train_step(config, pyramid_spec=None, impl: str = "auto", group=None):
    """``train_step(state, batch, epoch, pyramid=None) -> (state,
    StepMetrics)``, updating ``state`` in place.

    ``batch``: tensors on the model's device, ``points`` [C0, 3],
    ``features`` [C0, F], ``lengths`` [2], ``corr`` [M, 2], ``corr_valid``
    [M], ``dist_keypts`` [M, M] — one packed pair (``data.pack.pack_pair``).
    ``pyramid``: a pyramid of those points built elsewhere (either route),
    used instead of building one. ``impl`` selects kernels or their plain
    twins (see ``ops.select.band_select``). With a process ``group``, the
    data-parallel step of this rank's pair (module docstring)."""
    _compute_dtype(config)
    pyramid_spec = pyramid_spec or make_pyramid_spec(config)

    def train_step(state: TrainState, batch, epoch, pyramid=None):
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = _forward_losses(model, batch, config, pyramid_spec, train=True,
                                        impl=impl, pyramid=pyramid)
        loss.backward()
        grads = [t.grad for _, t in train_tensors(model) if t.grad is not None]
        vals = torch.stack([loss.detach(), *(m.detach().float() for m in metrics)])
        if group is not None:  # overflow (0 or 1) rides the sum: its max is (mean > 0)
            vals = reduce_mean(grads, vals, group)
            vals[-1] = (vals[-1] > 0).float()
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        # one device-to-host copy for the skip decision and the metrics
        vals = torch.cat([vals, finite.float()[None]]).tolist()
        loss_v, desc_l, det_l, acc, d_pos, d_neg, overflow, ok = vals
        lr = learning_rate(config, epoch)
        if ok:
            optimizer_step(config, state.optimizer, model, lr)
            state.step += 1
        return state, StepMetrics(loss=loss_v, desc_loss=desc_l, det_loss=det_l, accuracy=acc,
                                  d_pos=d_pos, d_neg=d_neg, lr=lr, skipped=1.0 - ok,
                                  overflow=overflow)

    return train_step


def make_eval_step(config, pyramid_spec=None, impl: str = "auto", group=None):
    """Validation step ``eval_step(model, batch, pyramid=None) ->
    StepMetrics``: the same losses with the eval detector head, no
    gradients. With a process ``group`` the metrics are averaged across
    its ranks and the overflow flag is their max."""
    _compute_dtype(config)
    pyramid_spec = pyramid_spec or make_pyramid_spec(config)

    @torch.no_grad()
    def eval_step(model, batch, pyramid=None):
        loss, metrics = _forward_losses(model, batch, config, pyramid_spec, train=False,
                                        impl=impl, pyramid=pyramid)
        vals = torch.stack([loss, *(m.float() for m in metrics)])
        if group is not None:
            vals = reduce_mean([], vals, group)
            vals[-1] = (vals[-1] > 0).float()
        vals = vals.tolist()
        loss_v, desc_l, det_l, acc, d_pos, d_neg, overflow = vals
        return StepMetrics(loss=loss_v, desc_loss=desc_l, det_loss=det_l, accuracy=acc,
                           d_pos=d_pos, d_neg=d_neg, lr=0.0, skipped=0.0, overflow=overflow)

    return eval_step


def make_extract_step(config, pyramid_spec=None, num_clouds: int = 2, impl: str = "auto"):
    """``extract_step(model, batch, pyramid=None) -> (features [C0, D],
    scores [C0, 1], overflow [] bool)`` for a packed ``batch`` of tensors
    (``points`` [C0, 3], ``features`` [C0, F], ``lengths`` [num_clouds]) on
    the model's device; ``pyramid`` as in ``make_train_step``. Scores use
    per-cloud max normalisation, so fragments batched on the cloud axis do
    not perturb each other. ``impl`` selects kernels or their plain twins
    (see ``ops.select.band_select``)."""
    compute_dtype = _compute_dtype(config)
    pyramid_spec = pyramid_spec or make_pyramid_spec(config, num_clouds=num_clouds)

    @torch.no_grad()
    def extract_step(model, batch, pyramid=None):
        pyr = pyramid if pyramid is not None else build_pyramid(
            batch["points"], batch["lengths"], spec=pyramid_spec, impl=impl)
        order0, inv0 = sorted_order(pyr)
        if order0 is None:
            out = apply_kpfcnn(model, dict(pyr, features=batch["features"]),
                               per_cloud_norm=True, impl=impl, compute_dtype=compute_dtype)
            return out.features, out.scores, pyr["overflow"]
        full = dict(pyr, features=permute_rows(batch["features"], order0))
        out = apply_kpfcnn(model, full, per_cloud_norm=True, impl=impl,
                           compute_dtype=compute_dtype)
        # back to the caller's original row order
        return (permute_rows(out.features, inv0), permute_rows(out.scores, inv0),
                pyr["overflow"])

    return extract_step
