"""Build the CUDA kernels under ``ops/cuda/`` with ``nvcc`` and load them
through ``ctypes``.

Each ``<name>.cu`` exposes ``extern "C"`` launchers that take device
pointers, sizes and a ``cudaStream_t``, launch on that stream and return
``cudaGetLastError()``. The shared library is built at first use into
``d3feat_tpu_torch/_build/<name>-<hash>.so``, keyed on a hash of the source,
the shared ``.cuh`` headers and the flags, under a file lock so concurrent
processes build it once.
Nothing here needs the PyTorch headers or ninja.

``build_host`` compiles a host C++ source (``native/src/geometry.cpp``)
with ``g++`` and ``HOST_FLAGS`` the same way: into ``_build/``, keyed on a
hash of the source and the flags, under the same lock.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Callable, Dict, Iterable, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "ops", "cuda")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: the kernels compare squared distances against thresholds bit
# for bit, so no multiply-add may be contracted behind the source's back;
# every fused multiply-add is an explicit __fmaf_rn.
NVCC_FLAGS = ("-O3", "-std=c++17", "-arch=sm_90a", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC")

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

# every kernel source under cuda/; the first load builds all that are missing
KERNELS = ("select", "band_lists", "band_conv", "head", "band_conv_bwd", "head_bwd",
           "deform_conv")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCHERS: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def _target(name: str) -> str:
    """Library path keyed on the source, every shared header and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(SRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def _build_lock():
    """``BUILD_DIR``'s file lock, held exclusively."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named kernel source that has no up-to-date library,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each build took (0.0 when it was already built)."""
    import time

    names = list(names)
    with _build_lock():
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            so = _target(name)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(SRC_DIR, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, so)
        secs = {name: 0.0 for name in names}
        errors = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
    return secs


def host_target(src: str) -> str:
    """Library path of the host source ``src``, keyed on it and ``HOST_FLAGS``."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"host_{stem}-{h.hexdigest()[:16]}.so")


def build_host(src: str) -> str:
    """Compile the host C++ source ``src`` with ``g++`` and ``HOST_FLAGS``
    unless its library is up to date; returns the library's path. A failed
    build raises with the compiler's log."""
    so = host_target(src)
    with _build_lock():
        if os.path.exists(so):
            return so
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH")
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src} (rc {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, so)
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``ops/cuda/<name>.cu``. When it is not built
    yet, every kernel of ``KERNELS`` without an up-to-date library is
    built, all at once."""
    lib = _LIBS.get(name)
    if lib is None:
        so = _target(name)
        if not os.path.exists(so):
            build(sorted(set(KERNELS) | {name}))
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
    return lib


def launcher(name: str, symbol: str, argtypes) -> Callable[..., int]:
    """The ``extern "C"`` launcher ``symbol`` of ``ops/cuda/<name>.cu``,
    bound once: its argument types and ``int`` result type are set when it
    is first asked for, not on every call."""
    fn = _LAUNCHERS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LAUNCHERS[(name, symbol)] = fn
    return fn


def uses_kernel(impl: str, t) -> bool:
    """Whether a call on tensor ``t`` runs the kernel or its plain twin:
    ``"auto"`` the kernel on a CUDA tensor and the twin anywhere else,
    ``"kernel"`` always the kernel, ``"plain"`` always the twin. Any other
    ``impl`` raises ``ValueError``."""
    if impl == "auto":
        return t.is_cuda
    if impl in ("kernel", "plain"):
        return impl == "kernel"
    raise ValueError(f"impl must be 'auto', 'kernel' or 'plain', got {impl!r}")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t, dtype, name: str) -> None:
    """Wrapper-side launch checks: CUDA device, dtype, contiguity, and the
    16-byte alignment that ``float4`` row loads need."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
