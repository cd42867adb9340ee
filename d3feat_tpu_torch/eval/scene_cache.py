"""Held-out eval scenes and their cache (one npz per scene): the port of
``tools/scene_cache.py`` and of ``tools/ab_recall.py::make_scene``.

Scenes are ray-traced multi-fragment rooms with exact ground-truth poses;
a fragment pair is scored when at least 30 % of one fragment lies within
0.1 of the other (the 3DMatch gt.log convention). Generation is minutes of
host CPU per scene, so scenes are cached: ``artifacts/eval_cache`` holds
the held-out scenes the recall entry point reads. The file names and the
npz layout are the JAX tools', and a scene missing from the cache is
generated draw for draw as those tools generate it.
"""

from __future__ import annotations

import os

import numpy as np

from d3feat_tpu_torch.data.augment import random_rotation, random_so3
from d3feat_tpu_torch.data.synthetic import _fused_views, make_room, make_warp_field
from d3feat_tpu_torch.data.threedmatch import voxel_downsample


def cache_path(cache_dir: str, seed: int, fragments: int, frame: str,
               warp: float) -> str:
    return os.path.join(
        cache_dir, f"scene_{seed}_{fragments}_{frame}_{warp}.npz")


def save_scene(path: str, frags, poses) -> None:
    """Atomic write (tmp + rename): a concurrent reader never sees a
    partial file and an interrupted run is simply regenerated."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, n_frags=len(frags),
             pair_keys=np.array(list(poses)),  # '<U..' strings
             **{f"frag_{i}": f for i, f in enumerate(frags)},
             **{f"pose_{k}": p for k, p in poses.items()})
    os.replace(tmp, path)


def load_scene(path: str):
    with np.load(path) as z:
        frags = [z[f"frag_{i}"] for i in range(int(z["n_frags"]))]
        poses = {str(k): z[f"pose_{k}"] for k in z["pair_keys"]}
    return frags, poses


def get_scene(seed: int, fragments: int, frame: str, warp: float,
              resolution=(120, 90), cache_dir=None):
    """Load the scene from the cache, or generate (and cache) it."""
    path = cache_path(cache_dir, seed, fragments, frame, warp) \
        if cache_dir else None
    if path and os.path.exists(path):
        return load_scene(path)
    rng = np.random.default_rng(seed)
    frags, poses, _ = make_scene(rng, fragments, resolution,
                                 frame=frame, warp=warp)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        save_scene(path, frags, poses)
    return frags, poses


def make_scene(rng, n_frags, resolution, downsample=0.03, frame="axis",
               warp=0.0):
    """Fragments in local frames + exact gt poses + overlap fractions.

    ``frame`` picks the per-fragment frame distribution: ``'axis'``
    (default) rotates each fragment about one random principal axis — the
    invariance class the reference's training augmentation covers
    (reference: datasets/ThreeDMatch.py:14-28; its non-rotated 3DMatch
    benchmark likewise has limited relative rotations — the SAME pretrained
    model collapses on the fully-rotated variant). ``'so3'`` uses uniform
    proper rotations (the harder, rotated-benchmark analogue).
    """
    room = make_room(rng)
    lo, hi = room[0], room[1]
    center = (lo + hi) / 2.0
    # one field for the whole scene: every fragment sees the same warped
    # world, exactly like the training corpus (gen_corpus --warp)
    field = make_warp_field(rng, amplitude=warp) if warp > 0.0 else None
    world, frames = [], []
    for _ in range(n_frags):
        w = np.zeros((0, 3))
        while len(w) < 2000:
            eye = rng.uniform(lo + [0.4, 0.4, 1.0],
                              np.maximum(hi - 0.4, lo + 0.5))
            eye[2] = min(eye[2], hi[2] - 0.4)
            tgt = center + rng.uniform(-0.8, 0.8, 3)
            raw = _fused_views(rng, room, eye, tgt, 3, resolution)
            if field is not None:
                raw = field(raw)
            w = voxel_downsample(raw, downsample)
        world.append(w)
        c = w.mean(axis=0)
        # proper rotation either way: frames are rigid motions
        q = random_so3(rng) if frame == "so3" else random_rotation(rng, 1)
        frames.append((q, c))

    frags = [((w - c) @ q).astype(np.float32)
             for w, (q, c) in zip(world, frames)]

    from scipy.spatial import cKDTree

    poses, overlaps = {}, {}
    for i in range(n_frags):
        tree = cKDTree(world[i])
        for j in range(i + 1, n_frags):
            d, _ = tree.query(world[j], k=1, distance_upper_bound=0.1)
            ov = float(np.isfinite(d).mean())
            overlaps[f"{i}_{j}"] = ov
            if ov < 0.30:  # the 3DMatch gt.log 30%-overlap criterion
                continue
            qi, ci = frames[i]
            qj, cj = frames[j]
            gt = np.eye(4)
            gt[:3, :3] = qi.T @ qj  # frag2 = t @ gt[:3,:3].T + gt[:3,3]
            gt[:3, 3] = (cj - ci) @ qi
            poses[f"{i}_{j}"] = gt
    return frags, poses, overlaps
