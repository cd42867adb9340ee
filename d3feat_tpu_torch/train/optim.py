"""Optimizer and learning-rate schedule (port of ``d3feat_tpu.train.optim``).

The reference's semantics: SGD with momentum (dampening 0) and L2 weight
decay folded into the gradient, or Adam with the same decay, at
``learning_rate(epoch)`` = base * gamma^floor(epoch / interval), set on the
optimizer before each step.

As in the JAX package, where the rigid kernel points are leaves of the
parameter tree, the optimizer also updates every KPConv's
``kernel_points`` buffer: its gradient is zero, but weight decay and the
momentum trace (or Adam's moments) still move it. An optional global-norm
clip scales the gradients by ``c / |g|`` when ``|g| >= c`` (optax's rule).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def learning_rate(config, epoch) -> float:
    """lr during ``epoch`` (0-indexed), computed in float32 as the JAX
    package computes it: ``lr * float32(gamma) ** (float32(epoch) //
    interval)``."""
    f32 = torch.float32
    steps = torch.floor_divide(torch.tensor(epoch, dtype=f32),
                               torch.tensor(float(config.scheduler_interval), dtype=f32))
    lr = torch.tensor(config.lr, dtype=f32) * torch.pow(
        torch.tensor(config.scheduler_gamma, dtype=f32), steps)
    return float(lr)


def train_tensors(model: torch.nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of everything the optimizer updates: the parameters,
    then the KPConv kernel-point buffers, by ``state_dict`` name."""
    return [*model.named_parameters(),
            *((n, b) for n, b in model.named_buffers() if n.endswith("kernel_points"))]


def make_optimizer(config, model: torch.nn.Module) -> torch.optim.Optimizer:
    """``torch.optim.SGD`` or ``Adam`` over ``train_tensors(model)``, with
    the configured momentum and weight decay (the lr is set per step)."""
    tensors = [t for _, t in train_tensors(model)]
    name = config.optimizer.upper()
    if name == "SGD":
        return torch.optim.SGD(tensors, lr=config.lr, momentum=config.momentum, dampening=0.0,
                               weight_decay=config.weight_decay)
    if name in ("ADAM", "ADAMW"):
        # the reference's torch.optim.Adam(weight_decay=...): L2 into the gradient
        return torch.optim.Adam(tensors, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=config.weight_decay)
    raise ValueError(f"unknown optimizer {config.optimizer!r}")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: with ``n`` the norm of
    all gradients together, ``g <- (g / n) * max_norm`` when ``n >= max_norm``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def optimizer_step(config, optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                   lr: float) -> None:
    """One update at ``lr`` from the gradients in ``.grad``: absent
    gradients (kernel points, unused parameters) count as zero, then the
    optional clip."""
    grads = []
    for _, t in train_tensors(model):
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        grads.append(t.grad)
    if config.grad_clip_norm > 0.0:
        clip_by_global_norm(grads, config.grad_clip_norm)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
