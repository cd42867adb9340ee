"""d3feat_tpu_torch — the PyTorch/CUDA port of ``d3feat_tpu`` for one H100.

The JAX package ``d3feat_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of it
(nor ``jax``). Plain tensor code is PyTorch; the five Pallas kernels are
hand-written CUDA kernels under ``ops/cuda/`` (K1 band select, K2 band
KPConv, K3 detector-head band sums, and the backward kernels of the
training path, K4 band-KPConv backward and K5 band-head backward), built at
first use with ``nvcc`` into ``_build/`` and called through ``ctypes``.
Each kernel has a plain PyTorch twin in the same module, which runs for
CPU tensors.

Paths: serving extraction (``eval/extract.py::FeatureExtractor``, K1-K3),
the train step (``train/step.py``, K1-K5) and registration recall:
``eval/`` (keypoint selection, mutual-NN matching, inlier counts,
``register_scene``, gt logs, ``generate_features``), the
held-out scene cache (``eval/scene_cache.py``) and the test set
(``data/threedmatch.py``, ``data/ply.py``), driven by the entry points
``python3 -m d3feat_tpu_torch.final_recall`` and ``python3 -m
d3feat_tpu_torch.test_3dmatch``, and training: ``train/trainer.py::Trainer``
on the pair datasets (``data/synthetic.py``, ``data/threedmatch.py``,
``data/prepare.py``) through ``data/loader.py::PairLoader``, with
snapshots (``train/checkpoint.py``) and the portable npz both ways
(``compat/portable.py``), driven by ``python3 -m
d3feat_tpu_torch.train_3dmatch`` on a corpus that ``python3 -m
d3feat_tpu_torch.gen_corpus`` writes. Reference ``.pth`` checkpoints go
both ways through ``compat/torch_export.py`` and ``compat/torch_import.py``;
``native/`` builds the host geometry (``g++``) that ``data/prepare.py``
searches with; ``utils/metrics.py`` holds the classification metrics, and
``utils/profiling.py`` the port's spans and host-sync ranges (``port.*``
in a ``torch.profiler`` trace, recorded only while a profiler records)
and the trace exporter.

Entry points default to ``device="cuda"`` and raise when CUDA is missing;
tests pass ``device="cpu"`` explicitly.
"""

import subprocess

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


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
