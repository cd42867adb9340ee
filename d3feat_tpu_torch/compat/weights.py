"""Carry weights, model state and optimizer state into the port's
``KPFCNN`` and ``KPCNN`` modules.

Two sources of weights: the JAX parameter pytree handed over as nested
numpy arrays (``params_from_numpy``; the tests use it to run both stacks
on the same random weights), and the committed portable npz
(``load_npz``). Parameters keep their JAX key paths as ``state_dict``
names (batch norm's ``scale``/``offset``, a deformable conv's
``offset_weights``/``offset_kernel_points``/``offset_bias`` included).
The JAX model state, the batch norms' running ``mean`` and ``var``, maps
onto the ``BatchNorm`` buffers by ``state_names``: the state of a unary
layer's norm sits on the unary itself in JAX's tree
(``encoder.1.unary1.mean``, the port's ``encoder.1.unary1.norm.mean``),
every other norm's under its own path (``encoder.0.norm.mean``).
``state_from_numpy`` maps a JAX state tree, ``model_trees`` splits a model
into the two trees of the portable npz, which ``load_npz`` reads back.
Optimizer state is compared by parameter name: an optax state tree shaped
like the parameters (SGD's momentum trace, Adam's moments) flattens with
``params_from_numpy`` to the same names that ``optimizer_state_by_name``
gives the port's ``torch.optim`` state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from d3feat_tpu_torch.compat.portable import export_npz, read_npz


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


def state_names(model: torch.nn.Module) -> Dict[str, str]:
    """``{buffer name: JAX model-state name}`` of every batch norm's
    running ``mean`` and ``var`` in ``model`` (module docstring)."""
    from d3feat_tpu_torch.models.blocks import BatchNorm, Unary

    unaries = {n for n, m in model.named_modules() if isinstance(m, Unary)}
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            parent, _, leaf = name.rpartition(".")
            prefix = parent if leaf == "norm" and parent in unaries else name
            for stat in ("mean", "var"):
                out[f"{name}.{stat}"] = f"{prefix}.{stat}"
    return out


def model_trees(model: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, torch.Tensor]]:
    """(params, model state) of ``model`` as the JAX package's two trees,
    by name: the parameters and kernel-point buffers under their
    ``state_dict`` names, the running statistics under their JAX names."""
    names = state_names(model)
    sd = model.state_dict()
    return ({k: v for k, v in sd.items() if k not in names},
            {names[k]: sd[k] for k in names})


def state_from_numpy(tree: Any, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """JAX model-state pytree (nested numpy arrays) -> ``{buffer name:
    tensor}`` of ``model``'s batch norms (CPU tensors, for
    ``load_state_dict(..., strict=False)``); every leaf must have a
    buffer and every buffer a leaf."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    by_jax = {j: n for n, j in state_names(model).items()}
    if set(flat) != set(by_jax):
        raise ValueError(f"model state does not match the model: missing "
                         f"{sorted(set(by_jax) - set(flat))[:4]}, extra "
                         f"{sorted(set(flat) - set(by_jax))[:4]}")
    return {by_jax[k]: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def load_npz(model: torch.nn.Module, path: str) -> dict:
    """Load an ``export_npz`` artifact, parameters and model state, into
    ``model`` (strict: every leaf of the artifact must match a parameter
    or buffer of the same shape and vice versa). Returns the artifact's
    meta."""
    params, state, meta = read_npz(path)
    by_jax = {j: n for n, j in state_names(model).items()}
    extra = sorted(set(state) - set(by_jax))
    if extra:
        raise ValueError(f"{path}: state leaves {extra[:4]} match no batch norm of the model")
    device = next(model.parameters()).device
    sd = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    sd.update({by_jax[k]: torch.from_numpy(v).to(device) for k, v in state.items()})
    model.load_state_dict(sd, strict=True)
    return meta


def export_model_npz(path: str, model: torch.nn.Module, meta: Optional[dict] = None) -> None:
    """``model``'s parameters and model state as a portable npz
    (``compat.portable.export_npz``), which JAX's ``import_npz`` and
    ``load_npz`` read."""
    export_npz(path, *model_trees(model), meta=meta)


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

