"""K7: the neighbourhood max, ``max_k x[inds[q, k]]``: kernel wrapper, plain
PyTorch twin and launch counters.

The strided blocks' max pool (``models/blocks.py::max_pool``, the
``max_pool`` block too) and the detector's local-max gate
(``models/kpfcnn.py::detection_scores``) take, for each query, the max of
its listed rows of ``x`` [S, C], the shadow index ``S`` reading a zero row
that takes part in the max.

The kernel is ``ops/cuda/neighbor_max.cu``; ``neighbor_max_plain`` is its
twin, the expression the port has always run (it materialises the
``[Q, K, C]`` gathered rows, then reduces them). ``neighbor_max`` picks one
(``impl``: ``"auto"``, ``"plain"``, ``"kernel"``) and counts what it did:
``neighbor_max.launches`` the maxima taken on K7,
``neighbor_max.launches_fallback`` those taken by the twin.
"""

from __future__ import annotations

import ctypes

import torch

from d3feat_tpu_torch.ops import build


def neighbor_max_plain(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Twin of K7, differentiable in ``x``: [Q, C], the max over each list
    of ``inds`` [Q, K] of the rows of ``x`` [S, C], index ``S`` (the
    shadow) reading a zero row (``models/kpconv.py::gather_rows``)."""
    from d3feat_tpu_torch.models.kpconv import gather_rows

    return gather_rows(x, inds).amax(1)


_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def neighbor_max_kernel(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Launch K7: the contract of ``neighbor_max_plain`` for contiguous
    float32 ``x`` and int32 ``inds`` on the card, K >= 1. No gradient."""
    for t, dtype, name in ((x, torch.float32, "x"), (inds, torch.int32, "inds")):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"neighbor_max: {name} must be a contiguous {dtype} CUDA tensor")
    if x.dim() != 2 or inds.dim() != 2 or inds.shape[1] < 1 or inds.device != x.device:
        raise ValueError("neighbor_max: x [S, C] and inds [Q, K >= 1] on one device")
    (nq, k), (ns, c) = inds.shape, x.shape
    out = torch.empty((nq, c), dtype=torch.float32, device=x.device)
    fn = build.launcher("neighbor_max", "neighbor_max_launch", _ARGS)
    rc = fn(build.ptr(x), ns, c, build.ptr(inds), nq, k, build.ptr(out), build.stream_of(x))
    build.check(rc, "neighbor_max_kernel")
    neighbor_max.launches += 1
    return out


def uses_kernel(impl: str, x: torch.Tensor, inds: torch.Tensor) -> bool:
    """Whether ``neighbor_max`` launches K7: ``"auto"`` on a CUDA tensor
    when the kernel computes the call (float32 rows, 2-D lists) and no
    gradient is needed; ``"kernel"`` always, raising where it cannot;
    ``"plain"`` never (``ops.build.uses_kernel``)."""
    if not build.uses_kernel(impl, x):
        return False
    fits = (x.dtype == torch.float32 and x.dim() == 2 and inds.dim() == 2
            and not (torch.is_grad_enabled() and x.requires_grad))
    if impl == "auto":
        return fits
    if not fits:
        raise ValueError("neighbor_max kernel: float32 [S, C] rows, [Q, K] lists, no gradient")
    return True


def neighbor_max(x: torch.Tensor, inds: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """The max over each neighbour list, on K7 or by the twin
    (``uses_kernel``): arguments and result as ``neighbor_max_plain``'s."""
    if uses_kernel(impl, x, inds):
        return neighbor_max_kernel(x.contiguous(), inds.to(torch.int32).contiguous())
    neighbor_max.launches_fallback += 1
    return neighbor_max_plain(x, inds)


neighbor_max.launches = 0
neighbor_max.launches_fallback = 0
