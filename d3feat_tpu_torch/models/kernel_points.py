"""Kernel-point dispositions for KPConv (port of
``d3feat_tpu.models.kernel_points``).

K kernel points inside a unit ball:

* K <= 30: repulsive-potential gradient descent over many random candidate
  kernels, keeping the candidate with the lowest final gradient norm;
* K > 30: Lloyd's algorithm with Monte-Carlo Voronoi-cell estimation.

The generators are numpy code, the same calls on the same dtypes as the
JAX package's, so a seed gives the same disposition bit for bit.
``load_kernels`` reads the committed disposition (``dispositions/``, a
copy of the JAX package's) when there is one; otherwise it generates it
and caches it in ``cache_dir`` (default: the git-ignored
``d3feat_tpu_torch/_build/dispositions``), never in a tracked directory.
With ``deterministic=False`` a seeded random z-rotation and N(0, 0.01)
jitter are applied before scaling, the reference's load-time augmentation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DISPOSITIONS = os.path.join(_PACKAGE, "models", "dispositions")
_CACHE_DIR = os.path.join(_PACKAGE, "_build", "dispositions")


def rotation_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix for a unit axis and an angle."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _init_in_ball(rng: np.random.Generator, n: int, dim: int, r_max: float) -> np.ndarray:
    """Uniform samples inside a ball of radius r_max via rejection."""
    pts = np.zeros((0, dim))
    while pts.shape[0] < n:
        cand = rng.uniform(-r_max, r_max, size=(2 * n, dim))
        cand = cand[np.sum(cand**2, axis=1) < r_max**2]
        pts = np.concatenate([pts, cand], axis=0)
    return pts[:n]


def _apply_fixed(points: np.ndarray, fixed: str) -> np.ndarray:
    """Pin special kernel points: the center and/or two vertical points."""
    if fixed in ("center", "verticals"):
        points[..., 0, :] = 0.0
    if fixed == "verticals":
        points[..., 1, :] = 0.0
        points[..., 2, :] = 0.0
        points[..., 1, -1] = 2.0 / 3.0
        points[..., 2, -1] = -2.0 / 3.0
    return points


def optimize_repulsion(num_points: int, dimension: int = 3, fixed: str = "center",
                       num_candidates: int = 100, ratio: float = 0.66, max_iter: int = 10000,
                       seed: int = 42):
    """Place kernel points by minimising a repulsive + centering potential,
    over ``num_candidates`` random initialisations at once: inverse-square
    repulsion between points, a linear attraction to the origin with weight
    10, fixed points held in place, stopping when the gradient norms stop
    changing, and a final rescale so the mean non-center radius is
    ``ratio``. Returns (points [num_candidates, num_points, dim], final
    gradient norms [num_candidates])."""
    rng = np.random.default_rng(seed)
    radius0 = 1.0
    step = 1e-2
    step_decay = 0.9995
    clip = 0.05 * radius0
    thresh = 1e-5

    kp = _init_in_ball(rng, num_candidates * num_points, dimension, radius0 * np.sqrt(0.5))
    kp = kp.reshape(num_candidates, num_points, dimension)
    kp = _apply_fixed(kp, fixed)
    n_fixed = {"center": 1, "verticals": 3}.get(fixed, 0)

    saved_norms = np.zeros(num_candidates)
    prev_norms = np.zeros((num_candidates, num_points))
    for it in range(max_iter):
        diff = kp[:, :, None, :] - kp[:, None, :, :]  # [C, K, K, dim]
        d2 = np.sum(diff**2, axis=-1)
        rep = diff / (np.power(d2[..., None], 1.5) + 1e-6)
        grads = np.sum(rep, axis=2) + 10.0 * kp  # repulsion + centering
        if fixed == "verticals":
            grads[:, 1:3, :-1] = 0.0

        norms = np.sqrt(np.sum(grads**2, axis=-1))  # [C, K]
        saved_norms = np.max(norms[:, n_fixed:], axis=1) if n_fixed else np.max(norms, axis=1)
        moving = norms[:, n_fixed:] if n_fixed else norms
        prev_moving = prev_norms[:, n_fixed:] if n_fixed else prev_norms
        if np.max(np.abs(prev_moving - moving)) < thresh:
            break
        prev_norms = norms

        dist = np.minimum(step * norms, clip)
        if n_fixed:
            dist[:, :n_fixed] = 0.0
        kp = kp - dist[..., None] * grads / (norms[..., None] + 1e-6)
        step *= step_decay

    r = np.sqrt(np.sum(kp**2, axis=-1))
    kp = kp * (ratio / np.mean(r[:, 1:], axis=1))[:, None, None]
    return kp, saved_norms


def lloyd_sphere(num_points: int, dimension: int = 3, fixed: str = "center",
                 approx_n: int = 5000, max_iter: int = 500, momentum: float = 0.9,
                 seed: int = 42) -> np.ndarray:
    """Lloyd relaxation of K cells in the unit ball (Monte-Carlo centroids),
    from a shell initialisation (radius in [0.9, 1.0))."""
    rng = np.random.default_rng(seed)
    kp = _init_in_ball(rng, num_points, dimension, 1.0)
    norms = np.linalg.norm(kp, axis=1, keepdims=True) + 1e-9
    kp = kp / norms * (0.9 + 0.1 * rng.random((num_points, 1)))
    kp = _apply_fixed(kp[None], fixed)[0]

    for _ in range(max_iter):
        X = rng.uniform(-1.0, 1.0, size=(approx_n, dimension))
        X = X[np.sum(X**2, axis=1) < 1.0]
        d2 = np.sum((X[:, None, :] - kp[None]) ** 2, axis=-1)
        cell = np.argmin(d2, axis=1)
        counts = np.bincount(cell, minlength=num_points).astype(np.float64)
        sums = np.zeros_like(kp)
        for d in range(dimension):
            sums[:, d] = np.bincount(cell, weights=X[:, d], minlength=num_points)
        centers = np.where(counts[:, None] > 0, sums / np.maximum(counts[:, None], 1), kp)
        kp = kp + (1 - momentum) * (centers - kp)
        kp = _apply_fixed(kp[None], fixed)[0]
    return kp


def generate_kernel_points(num_kpoints: int, dimension: int = 3, fixed: str = "center",
                           seed: int = 42) -> np.ndarray:
    """Unit-radius disposition: repulsion optimizer for K <= 30, Lloyd above."""
    if num_kpoints > 30:
        return lloyd_sphere(num_kpoints, dimension, fixed, seed=seed)
    kps, grad_norms = optimize_repulsion(num_kpoints, dimension, fixed, seed=seed)
    return kps[int(np.argmin(grad_norms))]


def load_kernels(radius: float, num_kpoints: int, dimension: int = 3, fixed: str = "center",
                 deterministic: bool = True, seed: Optional[int] = None,
                 cache_dir: Optional[str] = None) -> np.ndarray:
    """[num_kpoints, dimension] float32 kernel points scaled to ``radius``:
    the committed disposition, else the one cached in ``cache_dir``, else a
    generated one (then cached there); with ``deterministic=False`` the
    seeded z-rotation and jitter first (module docstring)."""
    fname = f"k_{num_kpoints:03d}_{fixed}_{dimension}D.npy"
    committed = os.path.join(_DISPOSITIONS, fname)
    cache_file = os.path.join(cache_dir or _CACHE_DIR, fname)
    if os.path.exists(committed):
        kp = np.load(committed)
    elif os.path.exists(cache_file):
        kp = np.load(cache_file)
    else:
        kp = generate_kernel_points(num_kpoints, dimension, fixed)
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        tmp = f"{cache_file}.{os.getpid()}.npy"  # whole files only, for concurrent readers
        np.save(tmp, kp)
        os.replace(tmp, cache_file)

    if not deterministic:
        rng = np.random.default_rng(seed)
        theta = rng.random() * 2 * np.pi
        if dimension == 3:
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        elif dimension == 2:
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s], [s, c]])
        else:
            R = np.eye(dimension)
        kp = kp + rng.normal(scale=0.01, size=kp.shape)
        kp = (radius * kp) @ R
    else:
        kp = radius * kp
    return kp.astype(np.float32)
