"""A reference PyTorch checkpoint -> the port's ``KPFCNN`` (port of
``d3feat_tpu.compat.torch_import``).

Reads reference-trained weights (reference: trainer.py:197-210 saves
``{epoch, state_dict, optimizer, scheduler, best_loss}``; README.md:49
links the pretrained model), and the ``.pth`` files that either package's
``save_torch_checkpoint`` writes, into the port's ``state_dict`` names: the
inverse of ``compat.torch_export.reference_names``, whose map this module
walks. The reference ``Linear.weight`` [out, in] is transposed into the
port's ``w`` [in, out]; KPConv weights [K, in, out] match directly; the
batch norms' running statistics become the ``BatchNorm`` buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from d3feat_tpu_torch.compat.torch_export import NUM_BATCHES, reference_names
from d3feat_tpu_torch.models.kpfcnn import KPFCNNSpecs


def _t(x) -> np.ndarray:
    """torch tensor / ndarray -> float32 ndarray."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class _SD:
    """State-dict view with presence tracking."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = sd
        self.used = set()

    def get(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(f"checkpoint is missing {key!r}")
        self.used.add(key)
        return _t(self.sd[key])

    def unused(self):
        return [k for k in self.sd if k not in self.used and NUM_BATCHES not in k]


def convert_state_dict(state_dict: Dict[str, Any], config,
                       specs: Optional[KPFCNNSpecs] = None, *,
                       strict: bool = True) -> Dict[str, torch.Tensor]:
    """Reference KPFCNN ``state_dict`` -> ``{name: CPU float32 tensor}``
    keyed exactly as a ``KPFCNN`` of ``config``'s ``state_dict()``,
    parameters and batch-norm buffers together. A missing key raises
    ``KeyError``; under ``strict`` a key left unconverted (other than
    ``num_batches_tracked``) raises ``ValueError``. Shapes are not checked
    here: ``load_state_dict`` refuses a mismatch."""
    sd = _SD(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for port, ref in reference_names(config, specs):
        if port is None:
            continue
        v = sd.get(ref)
        out[port] = torch.from_numpy(np.array(v.T if port.endswith(".linear.w") else v,
                                              order="C"))  # a copy, not a view of the input
    if strict:
        leftovers = sd.unused()
        if leftovers:
            raise ValueError(f"unconverted checkpoint keys: {leftovers[:8]}"
                             f"{'...' if len(leftovers) > 8 else ''}")
    return out


def load_torch_checkpoint(path: str, config, specs=None, *, strict: bool = True,
                          device="cuda"):
    """Load a reference ``.pth`` snapshot (full dict or bare state_dict)
    into a ``KPFCNN`` of ``config`` on ``device`` (``load_state_dict``,
    strict: every tensor of the model filled, every shape equal).

    Returns (model, meta) where meta carries epoch/best_loss when present
    (reference checkpoint layout, trainer.py:199-206)."""
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        sd = blob["state_dict"]
        meta = {k: blob[k] for k in ("epoch", "best_loss") if k in blob}
    else:
        sd, meta = blob, {}
    converted = convert_state_dict(sd, config, specs, strict=strict)
    model = init_kpfcnn(config, device=device, specs=specs)
    model.load_state_dict(converted, strict=True)
    return model, meta
