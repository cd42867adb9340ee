"""What every kind of traffic shares. A mix is a JSON file of parameters
(``traffic/<mix>.json``); its ``kind`` names the module
``kinds/<kind>.py`` that generates it, drives the window and checks it.

Inputs are the committed held-out scenes that the mix's ``scenes`` pattern
names: fragments already downsampled, with ground-truth poses of their
overlapping pairs. Every seed gets the same set of fragments or pairs in
each pass, in an order drawn from the seed, and every fragment, or each
cloud of a pair, gets a fresh random rotation (uniform over SO(3)) and a
translation uniform in ``[-translation, translation]^3`` on every use, so
every call builds a new pyramid. Correspondences are index pairs, so they
survive those motions; they are found once and kept in the checkout's
cache, keyed by the scene files' bytes and the radius.
"""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

from harness.manifest import ROOT

CACHE = os.path.join(ROOT, ".bench_cache")


def scene_files(pattern: str) -> list:
    """The scene files matching ``pattern`` (relative to the checkout), in
    order."""
    files = sorted(glob.glob(os.path.join(ROOT, pattern)))
    if not files:
        raise FileNotFoundError(f"no scene files match {pattern}")
    return files


def load_scenes(pattern: str):
    """(fragments [N_i, 3] float32, pairs (i, j, pose 4x4 moving fragment j
    into fragment i's frame)) of every scene file matching ``pattern``
    (relative to the checkout), in file order."""
    files = scene_files(pattern)
    frags, pairs = [], []
    for path in files:
        with np.load(path, allow_pickle=False) as z:
            base = len(frags)
            frags += [np.asarray(z[f"frag_{i}"], np.float32) for i in range(int(z["n_frags"]))]
            for key in z["pair_keys"]:
                i, j = (int(v) for v in str(key).split("_"))
                pairs.append((base + i, base + j, np.asarray(z[f"pose_{key}"], np.float64)))
    return frags, pairs


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """A rotation uniform over SO(3) (QR of a Gaussian, sign-fixed)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def move(rng: np.random.Generator, pts: np.ndarray, translation: float) -> np.ndarray:
    """``pts`` under a fresh random rigid motion, float32."""
    rot = random_rotation(rng)
    t = rng.uniform(-translation, translation, 3)
    return (pts.astype(np.float64) @ rot.T + t).astype(np.float32)


def crop_pair_to_budget(rng, w0, w1, pairs, max_points):
    """Both clouds cropped to the largest sphere (bisected) around a random
    correspondence anchor whose point total fits ``max_points``; returns
    (keep mask 0, keep mask 1, pairs remapped into the cropped clouds).
    A copy of the program's ``data/synthetic.py::crop_pair_to_budget``,
    returning masks."""
    center = w0[pairs[rng.integers(len(pairs)), 0]]
    d0 = np.linalg.norm(w0 - center, axis=1)
    d1 = np.linalg.norm(w1 - center, axis=1)
    lo, hi = 0.25, float(max(d0.max(), d1.max()))
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        if int((d0 <= mid).sum()) + int((d1 <= mid).sum()) <= max_points:
            lo = mid
        else:
            hi = mid
    m0, m1 = d0 <= lo, d1 <= lo
    inv0 = np.full(len(w0), -1, np.int64)
    inv0[np.nonzero(m0)[0]] = np.arange(int(m0.sum()))
    inv1 = np.full(len(w1), -1, np.int64)
    inv1[np.nonzero(m1)[0]] = np.arange(int(m1.sum()))
    remapped = np.stack([inv0[pairs[:, 0]], inv1[pairs[:, 1]]], axis=1)
    return m0, m1, remapped[(remapped >= 0).all(axis=1)].astype(np.int32)


def correspondences(p0: np.ndarray, p1: np.ndarray, pose: np.ndarray,
                    radius: float) -> np.ndarray:
    """[M, 2] (row of ``p0``, row of ``p1``): each point of ``p1``, moved by
    ``pose`` into ``p0``'s frame, with its nearest point of ``p0`` within
    ``radius``."""
    from scipy.spatial import cKDTree

    moved = p1.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]
    dist, idx = cKDTree(p0.astype(np.float64)).query(moved, distance_upper_bound=radius,
                                                       workers=-1)
    hit = np.isfinite(dist)
    return np.stack([idx[hit], np.nonzero(hit)[0]], 1).astype(np.int32)


def pair_correspondences(pattern: str, frags, pairs, radius: float) -> list:
    """``correspondences`` of every pair, read from the checkout's cache
    (``.bench_cache/corr-<key>.npz``, the key a hash of the scene files'
    bytes and ``radius``) or found and written there."""
    h = hashlib.sha256(f"corr v1 {radius!r}".encode())
    for path in scene_files(pattern):
        with open(path, "rb") as f:
            h.update(f.read())
    path = os.path.join(CACHE, f"corr-{h.hexdigest()[:24]}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            if int(z["n"]) == len(pairs):
                return [z[f"c{k}"] for k in range(len(pairs))]
    corr = [correspondences(frags[i], frags[j], pose, radius) for i, j, pose in pairs]
    os.makedirs(CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.npz"
    np.savez(tmp, n=np.array(len(pairs)), **{f"c{k}": c for k, c in enumerate(corr)})
    os.replace(tmp, path)
    return corr
