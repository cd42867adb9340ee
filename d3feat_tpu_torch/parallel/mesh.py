"""Process groups and batch placement for data parallelism (counterpart
of ``d3feat_tpu.parallel.mesh``).

The JAX package is single-controller: one process drives a 1-D mesh of N
devices and places pair i of a stacked ``[N, ...]`` batch on device i. The
port runs one process per device, as ``torchrun --nproc_per_node N``
starts them: rank i owns one device (``rank_device``) and takes pair i of
the same stacked batch (``shard_batch``); gradients and metrics meet in
collectives of the default process group, NCCL on CUDA devices and gloo
on the CPU (the tests). A CUDA run never falls back to gloo.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from d3feat_tpu_torch import resolve_device

TIMEOUT_S = 300.0  # a rank that fails before a collective stops the others after this


def rank_device(device, rank: int) -> torch.device:
    """The device that ``rank`` owns: on CUDA ``cuda:<local rank>``
    (torchrun's ``LOCAL_RANK``, else ``rank``, modulo the visible devices)
    unless ``device`` names an index; on the CPU the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_group(device="cuda", *, world_size: int = -1, rank: int = -1,
               init_method: Optional[str] = None, timeout_s: float = TIMEOUT_S):
    """(rank, world size) of the default process group, set up here or
    adopted when already initialised (its backend must be the device's:
    NCCL on CUDA, gloo on the CPU). ``init_method`` ``"file://<path>"`` or
    ``"tcp://host:port"`` with ``world_size`` and ``rank``; None reads
    torchrun's environment (``env://``). On CUDA the rank's device
    (``rank_device``) becomes the current one first, as NCCL needs. Every
    collective waits at most ``timeout_s``."""
    dev = resolve_device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"a {dev.type} run needs {want}")
        return dist.get_rank(), dist.get_world_size()
    own = None
    if dev.type == "cuda":
        own = rank_device(dev, rank if rank >= 0 else int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(own)
    dist.init_process_group(want, init_method=init_method or "env://", world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s), device_id=own)
    return dist.get_rank(), dist.get_world_size()


def stack_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Per-device batch dicts stacked along a new leading axis (the layout
    of ``data.loader.PairLoader``'s batches)."""
    return {k: np.stack([b[k] for b in batches], axis=0) for k in batches[0]}


def shard_batch(stacked, rank: int, device, world_size: int):
    """Pair ``rank`` of a stacked ``[world_size, ...]`` batch (numpy arrays
    or tensors), as tensors on ``device``: the counterpart of
    ``stack_shard_batch``'s placement. Raises unless the batch holds one
    pair per rank."""
    n = {len(v) for v in stacked.values()}
    if n != {world_size}:
        raise ValueError(f"stacked batch with leading sizes {sorted(n)} for "
                         f"{world_size} ranks")
    return {k: torch.as_tensor(v[rank]).to(device) for k, v in stacked.items()}
