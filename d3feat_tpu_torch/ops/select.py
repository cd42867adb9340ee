"""K1 band select: kernel wrapper and plain PyTorch twin.

Port of ``d3feat_tpu/ops/pallas/select.py::band_select``: for each query of
a tile of ``query_tile`` sorted queries, the ``K`` nearest candidates
(same cloud id, ``d2 <= r2``) among the tile's window of sorted support
rows ``[start, wend)``, ascending by squared distance, ties by ascending
position. Empty slots hold position ``Ns_pad - 1`` and d2 ``3e38``.

The kernel is ``ops/cuda/select.cu``; ``select_plain`` is its twin.
"""

from __future__ import annotations

import ctypes

import torch

from d3feat_tpu_torch.ops import build
from d3feat_tpu_torch.utils.profiling import span

EMPTY_D2 = 3.0e38
KMAX = 256  # top-K capacity of the kernel: eight slots per lane of a warp


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add, for
    broadcast operands.

    In float64 the product is exact, and the float64 sum rounded to float32
    is already the single-rounded result unless it lies exactly halfway
    between two float32 values (or in their subnormal range), where the
    float64 rounding may have decided the tie. Those entries, usually none,
    take the corrected value: TwoSum gives the sum's rounding error, which
    makes the float64 sum round-to-odd, and a round-to-odd value with 29
    spare bits rounds to float32 exactly as the single-rounded result. The
    correction is computed for every entry and selected, so the host never
    waits on the device to learn whether any entry needs it."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    fix = (((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000)
           | ((s.abs() < 2.0**-125) & (s != 0.0)))
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    nudge = fix & (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def exact_d2(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared distance in the kernels' op order: per axis d = s - q, then
    ``fma(dz, dz, fma(dx, dx, dy * dy))`` — the order in which the
    reference's d2 expression evaluates on the JAX CPU backend, so lists and
    thresholds agree with it bit for bit."""
    dx = s[..., 0] - q[..., 0]
    dy = s[..., 1] - q[..., 1]
    dz = s[..., 2] - q[..., 2]
    return fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))


def tile_windows(s_rows: torch.Tensor, starts: torch.Tensor, wends: torch.Tensor):
    """([n_tiles, W] support rows of each tile's window, their positions,
    and a validity mask); W is the widest window, short windows padded."""
    width = 0
    if starts.numel():
        with span("sync.window_width"):
            width = int((wends - starts).max().clamp(min=0))
    offs = torch.arange(width, device=s_rows.device)
    pos = starts.long()[:, None] + offs[None, :]
    inside = pos < wends.long()[:, None]
    pos = torch.where(inside, pos, 0)
    return s_rows[pos], pos, inside


def add_windows(values: torch.Tensor, pos: torch.Tensor, inside: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """[n_rows, C]: each tile's window rows ``values`` [n_tiles, W, C] added
    into the support rows they stand for, tile after tile in ascending
    order (the backward kernels' order), rows outside every window zero."""
    out = values.new_zeros((n_rows + 1, values.shape[-1]))  # row n_rows: padding
    rows = torch.where(inside, pos, n_rows)
    for t in range(values.shape[0]):
        out.index_add_(0, rows[t], values[t])
    return out[:n_rows]


def select_plain(q_rows, s_rows, starts, wends, *, query_tile: int, r2, max_k: int):
    """Twin of the K1 kernel (same contract), in plain PyTorch."""
    nq = q_rows.shape[0]
    n_tiles = nq // query_tile
    empty = s_rows.shape[0] - 1
    out_pos = torch.full((nq, max_k), empty, dtype=torch.int32, device=q_rows.device)
    out_d2 = torch.full((nq, max_k), EMPTY_D2, dtype=torch.float32, device=q_rows.device)
    if n_tiles == 0:
        return out_pos, out_d2
    rows, pos, inside = tile_windows(s_rows, starts, wends)       # [n, W, 4]
    q = q_rows.view(n_tiles, query_tile, 1, 4)
    s = rows[:, None]                                              # [n, 1, W, 4]
    d2 = exact_d2(s, q)                                            # [n, T, W]
    cand = inside[:, None] & (s[..., 3] == q[..., 3]) & (d2 <= r2)
    d2m = torch.where(cand, d2, torch.tensor(EMPTY_D2, device=d2.device))
    k = min(max_k, d2m.shape[-1])
    srt, idx = torch.sort(d2m, dim=-1, stable=True)  # window is position-ascending
    srt, idx = srt[..., :k], idx[..., :k]
    p = torch.gather(pos[:, None].expand(-1, query_tile, -1), 2, idx)
    keep = srt < EMPTY_D2
    out_pos[:, :k] = torch.where(keep, p, empty).reshape(nq, k).to(torch.int32)
    out_d2[:, :k] = srt.reshape(nq, k)
    return out_pos, out_d2


def select_slots(max_k: int) -> int:
    """Slots per lane of the kernel's distributed top-K list: 2 up to K =
    64, 4 up to 128, 8 up to ``KMAX``."""
    return 2 if max_k <= 64 else 4 if max_k <= 128 else 8


def select_block(nq: int, query_tile: int, max_k: int = 1) -> int:
    """Queries per CTA of the K1 kernel for a search of ``nq`` padded
    queries: 32 (8 warps of 4) from 8192 queries on, 8 (8 warps of 1) from
    2048, else 2 (2 warps of 1), so every search of the bench pyramid runs
    on at least 256 CTAs; at most 8 (one query a warp) above K = 64, where
    a list takes 4 or 8 slots a lane; halved until it divides the tile (a
    CTA's queries share one window)."""
    qb = 32 if nq >= 8192 else 8 if nq >= 2048 else 2
    if select_slots(max_k) > 2:
        qb = min(qb, 8)
    while query_tile % qb:
        qb //= 2
    return qb


_SELECT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int] + [
    ctypes.c_void_p] * 3


def select_kernel(q_rows, s_rows, starts, wends, *, query_tile: int, r2, max_k: int):
    """Launch the K1 CUDA kernel (same contract as ``select_plain``)."""
    for t, dt, name in ((q_rows, torch.float32, "q_rows"), (s_rows, torch.float32, "s_rows"),
                        (starts, torch.int32, "starts"), (wends, torch.int32, "wends")):
        build.require(t, dt, name)
    nq = q_rows.shape[0]
    if nq % query_tile or starts.shape[0] != nq // query_tile or not 1 <= max_k <= KMAX:
        raise ValueError("band_select: bad tile/shape arguments")
    out_pos = torch.empty((nq, max_k), dtype=torch.int32, device=q_rows.device)
    out_d2 = torch.empty((nq, max_k), dtype=torch.float32, device=q_rows.device)
    fn = build.launcher("select", "select_launch", _SELECT_ARGS)
    rc = fn(build.ptr(q_rows), build.ptr(s_rows), build.ptr(starts), build.ptr(wends), nq,
            query_tile, select_block(nq, query_tile, max_k), max_k, float(r2),
            s_rows.shape[0] - 1,
            build.ptr(out_pos), build.ptr(out_d2), build.stream_of(q_rows))
    build.check(rc, "select_kernel")
    band_select.launches += 1
    return out_pos, out_d2


def band_select(q_rows, s_rows, starts, wends, *, query_tile: int, r2, max_k: int,
                impl: str = "auto"):
    """([Nq_pad, max_k] int32 positions, [Nq_pad, max_k] float32 d2).

    ``q_rows`` [Nq_pad, 4] sorted queries (cloud id -1 on padding),
    ``s_rows`` [Ns_pad, 4] sorted supports, ``starts``/``wends`` [n_tiles]
    int32 windows (``neighbors.band_windows``). ``impl="auto"`` launches
    the kernel for CUDA tensors and runs the twin for CPU tensors;
    ``"plain"`` forces the twin (the card's kernel-vs-twin checks), as
    ``ops.build.uses_kernel`` decides."""
    if not build.uses_kernel(impl, q_rows):
        return select_plain(q_rows, s_rows, starts, wends, query_tile=query_tile,
                            r2=r2, max_k=max_k)
    return select_kernel(q_rows, s_rows, starts, wends, query_tile=query_tile,
                         r2=r2, max_k=max_k)


band_select.launches = 0
