"""d3feat_tpu_torch — the PyTorch/CUDA port of ``d3feat_tpu`` for one H100.

The JAX package ``d3feat_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of it
(nor ``jax``). Plain tensor code is PyTorch; the three Pallas kernels of the
serving path are hand-written CUDA kernels under ``ops/cuda/`` (K1 band
select, K2 band KPConv, K3 detector-head band sums), built at first use with
``nvcc`` into ``_build/`` and called through ``ctypes``. Each kernel has a
plain PyTorch twin in the same module, which runs for CPU tensors.

Entry points default to ``device="cuda"`` and raise when CUDA is missing;
tests pass ``device="cpu"`` explicitly.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for but absent
    (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' explicitly "
            "to run the plain PyTorch twins")
    return dev
