"""Native (C++) host-side geometry ops, loaded over ctypes (port of
``d3feat_tpu.native``).

Counterpart of the reference's CPython extension modules
(reference: cpp_wrappers/cpp_subsampling/wrapper.cpp,
cpp_wrappers/cpp_neighbors/wrapper.cpp) with the same observable semantics
(barycenter voxels; distance-sorted, shadow-padded neighbor rows) but a
cell-grid search design and a plain C ABI. ``src/geometry.cpp`` is the
port's own copy of the JAX package's source; ``ops.build.build_host``
compiles it with ``g++ -O3 -fopenmp`` into ``d3feat_tpu_torch/_build/`` at
first use. Used for offline dataset preparation
(``data/prepare.py::compute_correspondences``); the model's pyramid runs
the on-device versions in :mod:`d3feat_tpu_torch.ops`. A failed build
raises; nothing falls back to another route behind the caller's back.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "geometry.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile the shared library if it is not up to date (keyed on a hash
    of the source and the flags, never on mtimes); returns its path."""
    from d3feat_tpu_torch.ops.build import build_host

    return build_host(_SRC)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.d3f_grid_subsample_batch.restype = ctypes.c_int
            lib.d3f_grid_subsample_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.d3f_radius_neighbors_batch.restype = ctypes.c_int
            lib.d3f_radius_neighbors_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a query: the ops below
    raise on a failed build)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check_clouds(pts: np.ndarray, lens: np.ndarray, what: str) -> None:
    """The C side reads ``sum(lens)`` rows of ``pts`` unchecked."""
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"{what}: expected [N, 3] points, got {pts.shape}")
    if lens.ndim != 1 or (lens < 0).any() or int(lens.sum()) > len(pts):
        raise ValueError(f"{what}: lengths {lens.tolist()[:8]} do not fit {len(pts)} rows")


def grid_subsample_batch(points: np.ndarray, lengths, voxel: float,
                         capacity: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Barycenter voxel subsampling of stacked clouds.

    Returns (points [total, 3], lengths [B], overflow). Output rows are
    deterministically ordered by (cloud, voxel z, y, x).
    """
    lib = _load()
    pts = _f32(points)
    lens = _i32(lengths)
    _check_clouds(pts, lens, "points")
    cap = int(capacity) if capacity is not None else len(pts)
    if cap < 0:
        raise ValueError(f"capacity {cap} < 0")
    out = np.empty((cap, 3), np.float32)
    out_lens = np.zeros(len(lens), np.int32)
    total = np.zeros(1, np.int32)
    rc = lib.d3f_grid_subsample_batch(
        _p(pts, ctypes.c_float), _p(lens, ctypes.c_int32), len(lens), ctypes.c_float(voxel),
        _p(out, ctypes.c_float), cap, _p(out_lens, ctypes.c_int32), _p(total, ctypes.c_int32))
    return out[: int(total[0])].copy(), out_lens, bool(rc)


def radius_neighbors_batch(queries: np.ndarray, supports: np.ndarray, q_lengths, s_lengths,
                           radius: float, max_k: int) -> np.ndarray:
    """[Nq, max_k] int32 distance-sorted neighbor indices, shadow = Ns."""
    lib = _load()
    q = _f32(queries)
    s = _f32(supports)
    ql = _i32(q_lengths)
    sl = _i32(s_lengths)
    _check_clouds(q, ql, "queries")
    _check_clouds(s, sl, "supports")
    if len(ql) != len(sl) or max_k < 1:
        raise ValueError(f"{len(ql)} query clouds, {len(sl)} support clouds, max_k {max_k}")
    out = np.empty((len(q), max_k), np.int32)
    lib.d3f_radius_neighbors_batch(
        _p(q, ctypes.c_float), _p(ql, ctypes.c_int32), _p(s, ctypes.c_float),
        _p(sl, ctypes.c_int32), len(ql), ctypes.c_float(radius), max_k,
        _p(out, ctypes.c_int32))
    return out
