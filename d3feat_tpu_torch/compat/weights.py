"""Carry weights, and optimizer state, into the port's ``KPFCNN`` modules.

Two sources of weights: the JAX parameter pytree handed over as nested
numpy arrays (``params_from_numpy``; the tests use it to run both stacks
on the same random weights), and the committed portable npz
(``load_npz``). Optimizer state is compared by parameter name: an optax
state tree shaped like the parameters (SGD's momentum trace, Adam's
moments) flattens with ``params_from_numpy`` to the same names that
``optimizer_state_by_name`` gives the port's ``torch.optim`` state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from d3feat_tpu_torch.compat.portable import read_npz


def _walk(node: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if node is None:
        return  # absent optional leaf (e.g. KPConvParams.offset_weights)
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{prefix}{k}.", out)
    elif hasattr(node, "_fields"):  # NamedTuple (KPConvParams)
        for k in node._fields:
            _walk(getattr(node, k), f"{prefix}{k}.", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(node)


def params_from_numpy(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (dicts, lists, NamedTuples of numpy arrays) ->
    the port's ``state_dict`` (CPU tensors, same names as ``read_npz``)."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def load_npz(model: torch.nn.Module, path: str) -> dict:
    """Load an ``export_npz`` artifact into ``model`` (strict: every leaf of
    the artifact must match a parameter or buffer of the same shape and
    vice versa). Returns the artifact's meta."""
    params, state, meta = read_npz(path)
    if state:
        raise ValueError(
            f"{path}: model state (batch-norm statistics) is not supported "
            f"by the port yet ({len(state)} state leaves)")
    device = next(model.parameters()).device
    sd = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    model.load_state_dict(sd, strict=True)
    return meta


def optimizer_state_by_name(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{slot: {name: tensor}}`` of the optimizer's per-tensor state
    (``momentum_buffer`` for SGD, ``exp_avg``/``exp_avg_sq``/``step`` for
    Adam), names as in ``train.optim.train_tensors``."""
    from d3feat_tpu_torch.train.optim import train_tensors

    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in train_tensors(model):
        for slot, v in optimizer.state.get(t, {}).items():
            out.setdefault(slot, {})[name] = v
    return out

