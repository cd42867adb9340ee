"""The copy of an extraction step's outputs back to the host.

A step returns its padded outputs on the device: descriptors ``[C0, D]``,
scores ``[C0, 1]`` and the pyramid's overflow flag ``[]``. The caller needs
the first ``rows`` of them, the valid rows of its fragments. On the card,
:func:`to_host` copies just those rows and the flag into pinned host
memory with asynchronous copies and then waits once for the stream, so the
copies run at the bus's rate for pinned memory and the host waits for the
step and its copies in one sync (``port.sync.copy_out``). Elsewhere (the
CPU) the outputs are already host memory and their slices are returned with
no copy.

``to_host.launches`` counts the copies back staged through pinned memory.
"""

from __future__ import annotations

import torch

from d3feat_tpu_torch.utils.profiling import span


def to_host(feats: torch.Tensor, scores: torch.Tensor, overflow: torch.Tensor, rows: int):
    """(descriptors [rows, D], scores [rows], whether the step overflowed):
    the first ``rows`` rows of an extraction step's ``feats`` [C0, D] and
    ``scores`` [C0, 1] as float32 numpy arrays, C-contiguous, and its
    ``overflow`` flag as a bool.

    On a CUDA tensor the arrays are views of pinned host tensors from
    PyTorch's caching host allocator, each freshly allocated: they keep
    their memory while the caller holds them, so a later call never writes
    into an array already returned, and that memory stays pinned until the
    caller drops them (a scene's fragments hold a few hundred MB at most).
    """
    with span("sync.copy_out"):
        if feats.device.type != "cuda":
            return (feats[:rows].cpu().numpy(), scores[:rows, 0].cpu().numpy(),
                    bool(overflow))
        f = torch.empty((rows, feats.shape[1]), dtype=feats.dtype, pin_memory=True)
        s = torch.empty((rows,), dtype=scores.dtype, pin_memory=True)
        o = torch.empty((), dtype=overflow.dtype, pin_memory=True)
        f.copy_(feats[:rows], non_blocking=True)
        s.copy_(scores[:rows, 0], non_blocking=True)
        o.copy_(overflow, non_blocking=True)
        # one wait for the step and the three copies queued behind it; a
        # stream's wait, which set_sync_debug_mode counts (an event's it
        # does not)
        torch.cuda.current_stream(feats.device).synchronize()
        to_host.launches += 1
        return f.numpy(), s.numpy(), bool(o)


to_host.launches = 0
