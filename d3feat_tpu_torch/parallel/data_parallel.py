"""Data-parallel train, eval and extraction steps (counterpart of
``d3feat_tpu.parallel.data_parallel``).

Each rank of the process group processes one whole fragment pair per step
(``parallel.mesh.shard_batch`` cuts it from the stacked batch and places
it on the rank's device); parameters and optimizer state are replicated
(every rank starts from the same weights and applies the same update),
gradients and metrics are averaged inside the step
(``train.step.make_train_step`` with ``group``), as the JAX package's
``shard_map``'d steps ``pmean`` them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from d3feat_tpu_torch.train.step import make_eval_step, make_extract_step, make_train_step


def _group(group):
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError("data parallelism needs an initialised process group "
                               "(parallel.mesh.init_group)")
        group = dist.group.WORLD
    return group


def make_dp_train_step(config, group=None, pyramid_spec=None, impl: str = "auto"):
    """``train_step(state, batch, epoch) -> (state, StepMetrics)`` of this
    rank's pair ``batch`` (on its device) in ``group`` (default: the
    world). Batch norm with more than one rank raises: each rank would
    gather running statistics from its own pair (the JAX package refuses it
    too)."""
    group = _group(group)
    if config.use_batch_norm and dist.get_world_size(group) > 1:
        raise NotImplementedError(
            "data-parallel training with use_batch_norm=True diverges per-device "
            "batch-norm statistics; use the default bias norm")
    return make_train_step(config, pyramid_spec, impl=impl, group=group)


def make_dp_eval_step(config, group=None, pyramid_spec=None, impl: str = "auto"):
    """``eval_step(model, batch) -> StepMetrics`` of this rank's pair, the
    metrics averaged across ``group``."""
    return make_eval_step(config, pyramid_spec, impl=impl, group=_group(group))


def make_dp_extract_step(config, group=None, pyramid_spec=None, num_clouds: int = 2,
                         impl: str = "auto"):
    """``extract_step(model, batch) -> (features [N, C0, D], scores [N, C0,
    1], overflow [N] bool)``: this rank extracts its own packed ``batch``
    and every rank receives the outputs of all N ranks, rank i's at index i,
    as the JAX package's host holds them."""
    group = _group(group)
    step = make_extract_step(config, pyramid_spec, num_clouds=num_clouds, impl=impl)
    n = dist.get_world_size(group)

    def gather(t):
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t.contiguous(), group=group)
        return torch.stack(out)

    @torch.no_grad()
    def extract_step(model, batch):
        feats, scores, overflow = step(model, batch)
        return gather(feats), gather(scores), gather(overflow.to(torch.int32)[None])[:, 0] > 0

    return extract_step
