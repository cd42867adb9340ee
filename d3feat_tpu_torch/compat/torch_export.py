"""The port's ``KPFCNN`` -> the reference PyTorch ``state_dict`` (port of
``d3feat_tpu.compat.torch_export``).

A model of the port exports to the exact key and shape layout of the
reference torch ``KPFCNN`` (reference: models/architectures.py:216-320
module tree, trainer.py:197-210 checkpoint format), so reference-side
tooling and :mod:`d3feat_tpu_torch.compat.torch_import` read it. The name
map, port ``state_dict`` -> reference (``reference_names``):

  encoder.{i}.conv.{weights,kernel_points}   -> encoder_blocks.{i}.KPConv.{weights,kernel_points}
  encoder.{i}.conv.offset_{weights,kernel_points}
                                             -> encoder_blocks.{i}.KPConv.offset_conv.*
  encoder.{i}.conv.offset_bias               -> encoder_blocks.{i}.KPConv.offset_bias
  {unary1,unary2,shortcut}.linear.{w,b}      -> {unary1,unary2,unary_shortcut}.mlp.{weight,bias}
  norm / norm_conv (a unary's ``norm``)      -> batch_norm / batch_norm_conv (``batch_norm``)
  decoder.{i}                                -> decoder_blocks.{i}

The port's linear ``w`` is [in, out], torch ``Linear.weight`` [out, in]:
transposed. KPConv ``weights`` [K, in, out] match directly. Without batch
norm, ``Norm.bias`` goes to ``<norm>.bias``; with it, ``scale``/``offset``
and the running ``mean``/``var`` go to ``<norm>.batch_norm.{weight,bias,
running_mean,running_var}``, plus ``num_batches_tracked`` = int64 0 (the
reference's ``BatchNorm1d`` buffer, which nothing reads). Block indices are
the spec indices: pooling and upsampling blocks hold no parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from d3feat_tpu_torch.models.kpfcnn import KPFCNNSpecs, make_kpfcnn_specs

# a reference name with no tensor of the port behind it
NUM_BATCHES = "num_batches_tracked"


def _norm_names(port: str, ref: str, use_bn: bool) -> List[Tuple[Optional[str], str]]:
    if not use_bn:
        return [(port + ".bias", ref + ".bias")]
    p = ref + ".batch_norm"
    return [(port + ".scale", p + ".weight"), (port + ".offset", p + ".bias"),
            (port + ".mean", p + ".running_mean"), (port + ".var", p + ".running_var"),
            (None, f"{p}.{NUM_BATCHES}")]


def _unary_names(port: str, ref: str, use_bn: bool) -> List[Tuple[Optional[str], str]]:
    return [(port + ".linear.w", ref + ".mlp.weight"), (port + ".linear.b", ref + ".mlp.bias"),
            *_norm_names(port + ".norm", ref + ".batch_norm", use_bn)]


def _kpconv_names(port: str, ref: str, deformable: bool) -> List[Tuple[str, str]]:
    out = [(port + ".weights", ref + ".weights"), (port + ".kernel_points", ref + ".kernel_points")]
    if deformable:
        out += [(port + ".offset_weights", ref + ".offset_conv.weights"),
                (port + ".offset_kernel_points", ref + ".offset_conv.kernel_points"),
                (port + ".offset_bias", ref + ".offset_bias")]
    return out


def reference_names(config, specs: Optional[KPFCNNSpecs] = None
                    ) -> List[Tuple[Optional[str], str]]:
    """``[(port state_dict name or None, reference state_dict name)]`` of a
    ``KPFCNN`` of ``config``, in the JAX package's export order. A port
    name ending in ``.linear.w`` is the transpose of its reference tensor;
    ``None`` stands for the reference's ``num_batches_tracked``."""
    specs = specs or make_kpfcnn_specs(config)
    use_bn = config.use_batch_norm
    out: List[Tuple[Optional[str], str]] = []
    for i, spec in enumerate(specs.encoder):
        port, ref = f"encoder.{i}", f"encoder_blocks.{i}"
        if spec.kind == "simple":
            out += _kpconv_names(port + ".conv", ref + ".KPConv", spec.deformable)
            out += _norm_names(port + ".norm", ref + ".batch_norm", use_bn)
        elif spec.kind == "resnetb":
            if spec.in_dim != spec.out_dim // 4:
                out += _unary_names(port + ".unary1", ref + ".unary1", use_bn)
            out += _kpconv_names(port + ".conv", ref + ".KPConv", spec.deformable)
            out += _norm_names(port + ".norm_conv", ref + ".batch_norm_conv", use_bn)
            out += _unary_names(port + ".unary2", ref + ".unary2", use_bn)
            if spec.in_dim != spec.out_dim:
                out += _unary_names(port + ".shortcut", ref + ".unary_shortcut", use_bn)
    for i, spec in enumerate(specs.decoder):
        port, ref = f"decoder.{i}", f"decoder_blocks.{i}"
        if spec.kind == "unary":
            out += _unary_names(port, ref, use_bn)
        elif spec.kind == "last_unary":
            out += [(port + ".linear.w", ref + ".mlp.weight"),
                    (port + ".linear.b", ref + ".mlp.bias")]
    return out


def export_state_dict(model, config, specs: Optional[KPFCNNSpecs] = None
                      ) -> Dict[str, np.ndarray]:
    """``model``'s parameters and running statistics as a reference-layout
    ``state_dict`` of numpy values (float32, ``num_batches_tracked`` int64
    0), keyed and ordered as the JAX package's ``export_state_dict``."""
    sd = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    for port, ref in reference_names(config, specs):
        if port is None:
            out[ref] = np.asarray(0, np.int64)
            continue
        v = sd[port].detach().cpu().numpy().astype(np.float32)  # a copy, not a view of the model
        out[ref] = v.T if port.endswith(".linear.w") else v
    return out


def save_torch_checkpoint(path: str, model, config, specs=None, *, epoch: int = 0,
                          best_loss: float = 0.0) -> None:
    """Write a reference-format ``.pth`` snapshot (trainer.py:199-206
    layout: ``{epoch, state_dict, best_loss}``), which the reference's
    ``test.py --chosen_snapshot`` flow and ``load_torch_checkpoint`` read."""
    import torch

    sd = {k: (torch.from_numpy(np.ascontiguousarray(v)) if v.dtype != np.int64
              else torch.tensor(int(v)))
          for k, v in export_state_dict(model, config, specs).items()}
    torch.save({"epoch": epoch, "state_dict": sd, "best_loss": best_loss}, path)
