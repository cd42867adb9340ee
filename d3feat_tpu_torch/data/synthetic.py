"""Simulated depth-scan fragments (port of the scan generator of
``d3feat_tpu.data.synthetic``): rooms of rotated boxes, spheres and capped
cylinders, rendered by a pinhole depth camera with Kinect-like noise, fused
over a few nearby views and voxel-downsampled at the dataset resolution.
``draw_fragments`` keeps the ``scan_fragment`` draws within a size range;
the held-out scene generator (``eval/scene_cache.py``) warps its rooms with
``make_warp_field``, and the synthetic eval draws ``synthetic_fragment``.

The training pairs: ``synthetic_pair`` (a wavy patch and its augmented
copy), ``scan_pair_world`` (two overlapping fused scans of one room and
their candidate correspondences, the corpus's cacheable half),
``frame_scan_pair`` (the per-visit framing), the fit functions, and the
loader-compatible datasets ``SyntheticPairDataset``, ``ScanPairDataset``
and ``DiskScanPairDataset`` (a directory written by ``python3 -m
d3feat_tpu_torch.gen_corpus``).

Host numpy, copied draw for draw: the same ``np.random.Generator`` state
gives the JAX package's fragments and pairs bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from d3feat_tpu_torch.data.augment import (
    augment_pair,
    random_rotation,
    random_so3,
    random_translation,
)
from d3feat_tpu_torch.data.threedmatch import voxel_downsample


def synthetic_fragment(
    rng: np.random.Generator, n_points: int, extent: float = 3.0,
    noise: float = 0.005,
) -> np.ndarray:
    """[N, 3] wavy 2.5D surface patch sampled uniformly in x-y."""
    xy = rng.uniform(0.0, extent, size=(n_points, 2))
    z = (
        0.3 * np.sin(xy[:, 0] * 2.1)
        + 0.2 * np.cos(xy[:, 1] * 3.3)
        + 0.1 * np.sin(xy[:, 0] * xy[:, 1])
    )
    pts = np.column_stack([xy, z])
    return (pts + rng.normal(0.0, noise, pts.shape)).astype(np.float32)


class SyntheticPairDataset:
    """Loader-compatible dataset of synthetic overlapping pairs.

    Mirrors the interface of
    :class:`d3feat_tpu_torch.data.threedmatch.ThreeDMatchPairDataset` (``__len__``
    + ``packed``) so the trainer/loader stack can run hermetically.
    """

    def __init__(self, size: int = 16, n_points: int = 400, num_corr: int = 24,
                 extent: float = 2.0, seed: int = 0, **augment_kwargs):
        self.size = size
        self.n_points = n_points
        self.num_corr = num_corr
        self.extent = extent
        self.seed = seed
        self.augment_kwargs = augment_kwargs

    def __len__(self) -> int:
        return self.size

    def packed(self, index: int, *, point_capacity: int, corr_capacity: int):
        from d3feat_tpu_torch.data.pack import pack_pair

        rng = np.random.default_rng(self.seed * 100003 + index)
        pts0, pts1, corr, dk = synthetic_pair(
            rng, n_points=self.n_points, num_corr=self.num_corr,
            extent=self.extent, **self.augment_kwargs,
        )
        ones = np.ones((self.n_points, 1), np.float32)
        return pack_pair(
            pts0, pts1, ones, ones, corr, dk,
            point_capacity=point_capacity, corr_capacity=corr_capacity,
        )


def synthetic_pair(
    rng: np.random.Generator,
    n_points: int = 4096,
    num_corr: int = 128,
    extent: float = 3.0,
    **augment_kwargs,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """An overlapping fragment pair with known correspondences.

    Returns (pts0, pts1, corr [M,2], dist_keypts [M,M]): pts1 is a noisy
    SE(3) transform of the same underlying surface, and corr maps the first
    ``num_corr`` shared sample indices.
    """
    base = synthetic_fragment(rng, n_points, extent)
    pts0, pts1, _ = augment_pair(rng, base.copy(), base.copy(), **augment_kwargs)
    sel = rng.choice(n_points, size=min(num_corr, n_points), replace=False)
    corr = np.stack([sel, sel], axis=1).astype(np.int32)
    kp = pts0[sel]
    dist_keypts = np.linalg.norm(kp[:, None] - kp[None], axis=-1).astype(np.float32)
    return pts0, pts1, corr, dist_keypts


def _ray_room_exit(o, d, lo, hi):
    """t of the nearest room-wall hit from INSIDE the [lo, hi] box."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    t_far = np.maximum(t1, t2)          # per-axis exit t
    return np.min(t_far, axis=-1)       # first wall crossed


def _ray_box_enter(o, d, lo, hi):
    """t of the nearest hit on an interior box from OUTSIDE (inf = miss)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    t_near = np.max(np.minimum(t1, t2), axis=-1)
    t_far = np.min(np.maximum(t1, t2), axis=-1)
    hit = (t_near <= t_far) & (t_far > 0.0)
    t = np.where(t_near > 0.0, t_near, np.inf)
    return np.where(hit, t, np.inf)


def _ray_sphere_enter(o, d, center, radius):
    """t of the nearest outside hit on a sphere (inf = miss)."""
    oc = o - center[None, :]
    b = np.sum(d * oc, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - c
    with np.errstate(invalid="ignore"):
        t = -b - np.sqrt(disc)
    return np.where((disc > 0.0) & (t > 0.0), t, np.inf)


def _ray_vcyl_enter(o, d, cx, cy, radius, z0, z1):
    """t of the nearest hit on a capped vertical cylinder (inf = miss)."""
    ox, oy = o[..., 0] - cx, o[..., 1] - cy
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = ox * dx + oy * dy
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - a * c
    with np.errstate(invalid="ignore", divide="ignore"):
        t_side = (-b - np.sqrt(disc)) / a
    z = o[..., 2] + d[..., 2] * t_side
    t_side = np.where((disc > 0.0) & (t_side > 0.0)
                      & (z >= z0) & (z <= z1), t_side, np.inf)
    # caps: top disk (z1) and bottom disk (z0)
    with np.errstate(divide="ignore", invalid="ignore"):
        for zc in (z0, z1):
            t_cap = (zc - o[..., 2]) / d[..., 2]
            px = o[..., 0] + d[..., 0] * t_cap - cx
            py = o[..., 1] + d[..., 1] * t_cap - cy
            ok = (t_cap > 0.0) & (px * px + py * py <= radius * radius)
            t_side = np.minimum(t_side, np.where(ok, t_cap, np.inf))
    return t_side


def _ray_rotbox_enter(o, d, lo, hi, yaw_cs, pivot):
    """Nearest hit on a z-rotated box: rotate rays into the box frame."""
    c, s = yaw_cs
    ox, oy = o[..., 0] - pivot[0], o[..., 1] - pivot[1]
    o2 = np.stack([c * ox + s * oy + pivot[0],
                   -s * ox + c * oy + pivot[1], o[..., 2]], axis=-1)
    d2 = np.stack([c * d[..., 0] + s * d[..., 1],
                   -s * d[..., 0] + c * d[..., 1], d[..., 2]], axis=-1)
    return _ray_box_enter(o2, d2, lo, hi)


def _object_enter(o, d, obj):
    """Dispatch nearest-hit t for one tagged scene object."""
    kind = obj[0]
    if kind == "box":
        return _ray_box_enter(o, d, obj[1], obj[2])
    if kind == "rotbox":
        return _ray_rotbox_enter(o, d, obj[1], obj[2], obj[3], obj[4])
    if kind == "sphere":
        return _ray_sphere_enter(o, d, obj[1], obj[2])
    if kind == "cyl":
        return _ray_vcyl_enter(o, d, *obj[1:])
    raise ValueError(f"unknown scene object {kind!r}")


def _look_at(rng, eye, target):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1)  # columns = camera axes


def make_room(rng: np.random.Generator, n_boxes: int = 7):
    """(room_lo, room_hi, objects) for one scene.

    Objects are tagged tuples consumed by :func:`_object_enter`: yaw-rotated
    boxes, spheres, capped vertical cylinders, plus small "clutter" pieces
    stacked on top of larger ones. Axis-aligned boxes alone make every local
    neighborhood one of {plane, right-angle edge, corner} — geometrically
    indistinguishable classes that descriptor learning cannot separate
    (matching real indoor scans needs curvature and oblique surfaces, which
    real 3DMatch fragments have everywhere).
    """
    size = rng.uniform([3.0, 3.0, 2.4], [6.0, 6.0, 3.0])
    lo = np.zeros(3)
    objects = []
    n_objects = int(rng.integers(4, n_boxes + 2))
    for _ in range(n_objects):
        kind = rng.choice(["rotbox", "rotbox", "sphere", "cyl"])
        if kind == "rotbox":
            dims = rng.uniform([0.25, 0.25, 0.25], [1.5, 1.5, 1.8])
            pos = rng.uniform([0.3, 0.3, 0.0],
                              np.maximum(size - dims - 0.3, 0.4))
            yaw = rng.uniform(0.0, np.pi / 2)
            blo, bhi = pos, pos + dims
            objects.append(("rotbox", blo, bhi,
                            (np.cos(yaw), np.sin(yaw)),
                            (blo[:2] + bhi[:2]) / 2.0))
            # clutter: a small object resting on top (prob ~1/2)
            if bhi[2] < size[2] - 0.5 and rng.random() < 0.5:
                if rng.random() < 0.5:
                    r = rng.uniform(0.08, 0.25)
                    cxy = rng.uniform(blo[:2] + r, np.maximum(
                        bhi[:2] - r, blo[:2] + r + 1e-3))
                    objects.append(("sphere",
                                    np.array([cxy[0], cxy[1], bhi[2] + r]),
                                    r))
                else:
                    r = rng.uniform(0.06, 0.2)
                    h = rng.uniform(0.1, 0.5)
                    cxy = rng.uniform(blo[:2] + r, np.maximum(
                        bhi[:2] - r, blo[:2] + r + 1e-3))
                    objects.append(("cyl", cxy[0], cxy[1], r,
                                    bhi[2], bhi[2] + h))
        elif kind == "sphere":
            r = rng.uniform(0.15, 0.6)
            cxy = rng.uniform([0.3 + r, 0.3 + r],
                              np.maximum(size[:2] - 0.3 - r, 0.4 + r))
            # resting on the floor or floating (a lamp / plant canopy)
            cz = r if rng.random() < 0.7 else rng.uniform(r, size[2] - r)
            objects.append(("sphere", np.array([cxy[0], cxy[1], cz]), r))
        else:  # vertical capped cylinder (column / bin / table leg)
            r = rng.uniform(0.08, 0.45)
            h = rng.uniform(0.3, min(2.2, size[2] - 0.2))
            cxy = rng.uniform([0.3 + r, 0.3 + r],
                              np.maximum(size[:2] - 0.3 - r, 0.4 + r))
            objects.append(("cyl", cxy[0], cxy[1], r, 0.0, h))
    return lo, size, objects


def render_scan(
    rng: np.random.Generator,
    room,
    eye: np.ndarray,
    target: np.ndarray,
    resolution=(180, 135),
    fov_deg: float = 58.5,
    max_depth: float = 6.0,
) -> np.ndarray:
    """[N, 3] WORLD-frame depth-scan points from ``eye`` toward ``target``.

    Kinect-like depth noise grows quadratically with distance — the density
    and noise profile real fragments have."""
    lo, hi, objects = room
    w, h = resolution
    R = _look_at(rng, eye, target)
    tan = np.tan(np.radians(fov_deg) / 2.0)
    u = np.linspace(-tan, tan, w)
    v = np.linspace(-tan * h / w, tan * h / w, h)
    uu, vv = np.meshgrid(u, v)
    dirs_cam = np.stack([uu, vv, np.ones_like(uu)], axis=-1).reshape(-1, 3)
    dirs = dirs_cam @ R.T
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    o = eye[None, :]
    t = _ray_room_exit(o, dirs, lo, hi)
    for obj in objects:
        if isinstance(obj, tuple) and len(obj) == 2:  # legacy (lo, hi) box
            t = np.minimum(t, _ray_box_enter(o, dirs, obj[0], obj[1]))
        else:
            t = np.minimum(t, _object_enter(o, dirs, obj))
    keep = np.isfinite(t) & (t > 0.3) & (t < max_depth)
    t = t[keep]
    dirs = dirs[keep]
    depth_noise = 0.001 + 0.0019 * np.maximum(t - 0.4, 0.0) ** 2
    t = t + rng.normal(0.0, 1.0, t.shape) * depth_noise
    return (eye[None, :] + dirs * t[:, None]).astype(np.float32)


def _fused_views(rng, room, eye, target, n_views, resolution):
    """World-frame points fused from ``n_views`` nearby camera poses (real
    3DMatch fragments are 50-frame fusions — single views vary wildly in
    coverage when a wall is close)."""
    clouds = []
    for _ in range(n_views):
        e = eye + rng.uniform(-0.15, 0.15, 3)
        t = target + rng.uniform(-0.5, 0.5, 3)
        clouds.append(render_scan(rng, room, e, t, resolution=resolution))
    return np.concatenate(clouds, axis=0)


def scan_fragment(
    rng: np.random.Generator,
    resolution=(160, 120),
    downsample: float = 0.03,
    room=None,
    n_views: int = 4,
) -> np.ndarray:
    """One voxel-downsampled depth-scan fragment in its LOCAL (zero-mean)
    frame, ~10-20k points at the default resolution."""
    room = room or make_room(rng)
    lo, hi, _ = room
    pts = np.zeros((0, 3), np.float32)
    while len(pts) < 100:  # a camera inside furniture can see ~nothing
        eye = rng.uniform(lo + [0.4, 0.4, 1.0],
                          np.maximum(hi - 0.4, lo + 0.5))
        eye[2] = min(eye[2], hi[2] - 0.4)
        target = (lo + hi) / 2.0 + rng.uniform(-0.8, 0.8, 3)
        pts = _fused_views(rng, room, eye, target, n_views, resolution)
    pts = voxel_downsample(pts, downsample)
    return (pts - pts.mean(axis=0, keepdims=True)).astype(np.float32)


def draw_fragments(rng: np.random.Generator, count: int, n_min: int = 12000,
                   n_max: int = 16000, **scan_kw):
    """``count`` fragments of ``scan_fragment(rng, **scan_kw)``, each drawn
    again until its size is within [n_min, n_max] (by default the
    fragment sizes of the JAX package's ``bench.py``)."""
    out = []
    for _ in range(count):
        f = scan_fragment(rng, **scan_kw)
        while not (n_min <= len(f) <= n_max):
            f = scan_fragment(rng, **scan_kw)
        out.append(f)
    return out


def make_warp_field(rng: np.random.Generator, amplitude: float = 1.0):
    """Per-scene smooth random displacement field R^3 -> R^3.

    Exact geometric primitives make every wall patch a perfect plane, so
    uniformly-sampled correspondences are locally indistinguishable from
    far-away negatives and descriptor training stalls at its irreducible
    loss floor (measured: handcrafted-signature 1-NN accuracy ~7% vs 0.8%
    chance on the unwarped corpus). Real fused indoor scans are never
    piecewise-perfect — reconstruction residue and surface detail give
    every patch unique curvature. This field reproduces that: a sum of
    random sinusoids (wavelengths 0.10-0.55 m, RMS displacement ~2.4 cm at
    ``amplitude=1``) warping world space. Because it is a function of
    world position it is automatically consistent across fused views and
    across the two fragments of a pair.
    """
    n = 12
    wl = np.exp(rng.uniform(np.log(0.10), np.log(0.55), n))
    k = rng.normal(size=(n, 3))
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    k *= (2.0 * np.pi / wl)[:, None]
    phase = rng.uniform(0.0, 2.0 * np.pi, n)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # longer wavelengths displace more; short ones add curvature detail
    # (probe_data_discriminability: these parameters at amplitude 1.5-2
    # lift signature 1-NN accuracy 0.07 -> 0.22)
    amp = amplitude * 0.015 * (wl / wl.max()) ** 0.5

    def warp(x: np.ndarray) -> np.ndarray:
        ph = x @ k.T + phase  # [N, n]
        return (x + (np.sin(ph) * amp) @ dirs).astype(np.float32)

    return warp


def scan_pair_world(
    rng: np.random.Generator,
    resolution=(160, 120),
    downsample: float = 0.03,
    max_corr: int = 1024,
    corr_radius: float = 0.0375,
    warp: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two overlapping WORLD-FRAME scans of one room + candidate GT pairs.

    The expensive, cacheable half of :func:`scan_pair`: ray-traced fused
    scans and the correspondence candidates (point pairs within
    ``corr_radius`` in world space — the 3DMatch keypts-pickle
    construction). Frame randomization / per-visit augmentation happens in
    :func:`frame_scan_pair`, so one generated scene serves many training
    visits (see ``python3 -m d3feat_tpu_torch.gen_corpus`` and
    :class:`DiskScanPairDataset`).

    Returns (w0 [N0, 3], w1 [N1, 3], pairs [M, 2] with M <= max_corr).
    """
    from scipy.spatial import cKDTree

    # a degenerate camera draw can see (almost) nothing or share no
    # overlap; redraw the scene until both scans and the correspondence
    # set are usable
    for _ in range(32):
        room = make_room(rng)
        lo, hi, _ = room
        center = (lo + hi) / 2.0
        eye0 = rng.uniform(lo + [0.4, 0.4, 1.0],
                           np.maximum(hi - 0.4, lo + 0.5))
        eye0[2] = min(eye0[2], hi[2] - 0.4)
        eye1 = np.clip(eye0 + rng.uniform(-0.7, 0.7, 3),
                       lo + 0.35, hi - 0.35)
        tgt0 = center + rng.uniform(-0.8, 0.8, 3)
        tgt1 = tgt0 + rng.uniform(-0.6, 0.6, 3)

        r0 = _fused_views(rng, room, eye0, tgt0, 3, resolution)
        r1 = _fused_views(rng, room, eye1, tgt1, 3, resolution)
        if warp > 0.0:
            f = make_warp_field(rng, amplitude=warp)
            r0, r1 = f(r0), f(r1)
        w0 = voxel_downsample(r0, downsample)
        w1 = voxel_downsample(r1, downsample)
        if len(w0) < 256 or len(w1) < 256:
            continue

        tree = cKDTree(w1)
        dist, j = tree.query(w0, k=1, distance_upper_bound=corr_radius)
        ii = np.nonzero(np.isfinite(dist))[0]
        if len(ii) < 8:
            continue
        pairs = np.stack([ii, j[ii]], axis=1).astype(np.int32)
        if len(pairs) > max_corr:
            pairs = pairs[rng.choice(len(pairs), max_corr, replace=False)]
        return w0.astype(np.float32), w1.astype(np.float32), pairs
    raise RuntimeError("scan_pair: no usable scene after 32 draws")


def frame_scan_pair(
    rng: np.random.Generator,
    w0: np.ndarray,
    w1: np.ndarray,
    pairs: np.ndarray,
    num_corr: int = 128,
    noise: float = 0.0,
    rotation: str = "axis",
    augment_rotation: float = 1.0,
    augment_translation: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-visit augmentation for cached world-frame scenes.

    ``rotation='axis'`` (default) reproduces the reference's train-time
    distribution exactly (reference: datasets/ThreeDMatch.py:14-32,117-127):
    the source cloud keeps the shared world orientation, and the target gets
    ONE rotation about a random principal axis plus a uniform translation in
    [0, augment_translation)^3 — the invariance class the reference network
    actually learns. ``rotation='axis2'`` gives BOTH clouds independent
    single-principal-axis rotations: the relative rotation is then a
    PRODUCT of two axis rotations — exactly the class the held-out eval
    scenes draw (tools/ab_recall.make_scene gives every fragment its own
    axis frame), which pure-'axis' training demonstrably fails on (round-4
    scene-1: 0% recall at 72.7% on scene 0). ``rotation='mix'`` flips a
    fair coin per visit between 'axis' and 'axis2' — a curriculum that
    keeps the proven easy distribution while covering the eval class.
    ``rotation='so3'`` places BOTH clouds in independent
    proper SO(3) frames (a strictly harder task than the reference's;
    useful for robustness studies, not for parity training — full-SO(3)
    framing was measured to stall training at D_pos == D_neg).

    Correspondences are subsampled to ``num_corr`` and per-point uniform
    [0, noise) jitter matches reference ThreeDMatch.py:125-126;
    ``dist_keypts`` is computed from the noised source keypoints exactly as
    reference ThreeDMatch.py:135 does.
    """
    assert rotation in ("axis", "axis2", "mix", "so3"), rotation
    sel = pairs
    if len(sel) > num_corr:
        sel = sel[rng.choice(len(sel), num_corr, replace=False)]
    c = w0.mean(axis=0, keepdims=True)  # shared frame: one common recenter
    if rotation == "mix":
        rotation = "axis" if rng.random() < 0.5 else "axis2"
    if rotation == "axis":
        pts0, pts1, _ = augment_pair(
            rng, w0 - c, w1 - c, augment_noise=noise, augment_axis=1,
            augment_rotation=augment_rotation,
            augment_translation=augment_translation)
    elif rotation == "axis2":
        # both clouds in independent single-axis frames: relative rotation
        # = product of two principal-axis rotations (the eval-scene class)
        r0 = random_rotation(rng, 1, augment_rotation)
        r1 = random_rotation(rng, 1, augment_rotation)
        t1 = random_translation(rng, augment_translation)
        pts0 = (w0 - c) @ r0.T
        pts1 = (w1 - c) @ r1.T + t1
        if noise > 0.0:
            pts0 = pts0 + rng.random(pts0.shape) * noise
            pts1 = pts1 + rng.random(pts1.shape) * noise
        pts0 = pts0.astype(np.float32)
        pts1 = pts1.astype(np.float32)
    else:  # 'so3': independent full-rotation frames (harder than reference)
        c1 = w1.mean(axis=0, keepdims=True)
        pts0 = ((w0 - c) @ random_so3(rng)).astype(np.float32)
        pts1 = ((w1 - c1) @ random_so3(rng)).astype(np.float32)
        if noise > 0.0:
            pts0 = pts0 + rng.random(pts0.shape, dtype=np.float32) * noise
            pts1 = pts1 + rng.random(pts1.shape, dtype=np.float32) * noise

    kp = pts0[sel[:, 0]]
    dist_keypts = np.linalg.norm(
        kp[:, None] - kp[None], axis=-1).astype(np.float32)
    return pts0.astype(np.float32), pts1.astype(np.float32), \
        sel.astype(np.int32), dist_keypts


def scan_pair(
    rng: np.random.Generator,
    resolution=(160, 120),
    downsample: float = 0.03,
    num_corr: int = 128,
    corr_radius: float = 0.0375,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Two overlapping scans of one room with GT correspondences.

    Returns (pts0, pts1, corr [M, 2], dist_keypts [M, M]) in the dataset's
    layout (reference: datasets/ThreeDMatch.py:126-144): each cloud in its
    own frame, correspondences subsampled to ``num_corr``.
    """
    w0, w1, pairs = scan_pair_world(
        rng, resolution=resolution, downsample=downsample,
        max_corr=num_corr, corr_radius=corr_radius)
    return frame_scan_pair(rng, w0, w1, pairs, num_corr=num_corr)


def crop_pair_to_budget(rng, w0, w1, pairs, max_points):
    """Crop both clouds to a sphere around a random correspondence anchor,
    with the largest radius (bisected) whose point total fits the budget.

    Preserves the full scan density — a random point-thinning was measured
    to cost ~0.06 signature 1-NN discriminability on capped scenes because
    it undersamples the surface detail the descriptor task depends on.
    Centering on a GT-pair anchor keeps the crop inside the overlap region;
    pair indices are remapped into the cropped clouds. Used by
    ``python3 -m d3feat_tpu_torch.gen_corpus`` at generation time and by
    :class:`DiskScanPairDataset` at load time (every visit of an oversized
    scene trains on a different random full-density window — the
    fully-convolutional network evaluates on full rooms regardless).
    """
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
    remapped = remapped[(remapped >= 0).all(axis=1)].astype(np.int32)
    return w0[m0], w1[m1], remapped


def _subsample_pair_to_fit(rng, w0, w1, pairs, point_capacity, num_corr):
    """Random per-cloud subsample so len(w0)+len(w1) <= point_capacity.

    Budgets are proportional to cloud sizes; the endpoints of up to
    ``num_corr`` randomly chosen candidate pairs are always kept, so the
    correspondence supervision density survives the subsample. Remaining
    pair indices are remapped into the kept clouds. Prefer
    :func:`crop_pair_to_budget` (``fit_mode='crop'``) for training — the
    subsample mode preserves global extent but thins density.
    """
    n0, n1 = len(w0), len(w1)
    sel = pairs
    if len(sel) > num_corr:
        sel = sel[rng.choice(len(sel), num_corr, replace=False)]
    if point_capacity < 512:
        raise ValueError(f"point_capacity {point_capacity} < 512")
    k0 = min(max(256, point_capacity * n0 // (n0 + n1)),
             point_capacity - 256)
    k1 = point_capacity - k0

    def keep_set(n, k, must):
        k = min(max(k, len(must)), n)
        if k >= n:
            return np.arange(n)
        rest = np.setdiff1d(np.arange(n), must)
        extra = rng.choice(len(rest), k - len(must), replace=False)
        return np.concatenate([must, rest[extra]])

    keep0 = keep_set(n0, k0, np.unique(sel[:, 0]))
    keep1 = keep_set(n1, k1, np.unique(sel[:, 1]))
    inv0 = np.full(n0, -1, np.int64)
    inv0[keep0] = np.arange(len(keep0))
    inv1 = np.full(n1, -1, np.int64)
    inv1[keep1] = np.arange(len(keep1))
    p0, p1 = inv0[pairs[:, 0]], inv1[pairs[:, 1]]
    ok = (p0 >= 0) & (p1 >= 0)
    remapped = np.stack([p0[ok], p1[ok]], axis=1).astype(np.int32)
    return w0[keep0], w1[keep1], remapped


class DiskScanPairDataset:
    """Scan-pair corpus from a directory of pre-generated world-frame scenes.

    The single-CPU host cannot ray-trace scenes (~0.6 s each) as fast as
    the TPU trains (~0.1 s/step), so ``python3 -m d3feat_tpu_torch.gen_corpus``
    pre-generates
    the expensive half (fused scans + candidate correspondences,
    :func:`scan_pair_world`) as ``.npz`` files, and this dataset applies
    only the cheap per-visit augmentation at load time
    (:func:`frame_scan_pair`: reference-distribution SE(3) framing,
    correspondence subsample, point noise) — every visit of the same scene
    is a distinct training pair. The file list refreshes on every ``len()`` (i.e. each
    loader epoch), so the corpus can keep GROWING while training runs.
    """

    VAL_MOD = 50  # scene files with number % VAL_MOD == 0 are validation

    def __init__(self, root: str, num_corr: int = 128, seed: int = 0,
                 noise: float = 0.005, role: str = "all",
                 rotation: str = "axis", augment_rotation: float = 1.0,
                 augment_translation: float = 0.5,
                 fit_mode: str = "crop"):
        import threading

        assert role in ("all", "train", "val")
        assert fit_mode in ("crop", "subsample")
        self.fit_mode = fit_mode
        self.root = root
        self.num_corr = num_corr
        self.seed = seed
        self.noise = noise
        self.role = role
        self.rotation = rotation
        self.augment_rotation = augment_rotation
        self.augment_translation = augment_translation
        self._files: list = []
        self._visits = 0
        self._lock = threading.Lock()
        self._refresh()
        if not self._files:
            raise FileNotFoundError(
                f"no scene .npz files under {root} — run python3 -m d3feat_tpu_torch.gen_corpus")

    def _refresh(self):
        import glob
        import os

        files = sorted(glob.glob(os.path.join(self.root, "scene_*.npz")))
        if self.role != "all":
            # split by scene NUMBER (stable as the corpus grows): the same
            # file never moves between train and val across refreshes
            def num(p):
                return int(os.path.basename(p)[len("scene_"):-len(".npz")])

            want_val = self.role == "val"
            files = [p for p in files
                     if (num(p) % self.VAL_MOD == 0) == want_val]
        self._files = files

    def __len__(self) -> int:
        self._refresh()
        return max(len(self._files), 1)

    def packed(self, index: int, *, point_capacity: int, corr_capacity: int):
        from d3feat_tpu_torch.data.pack import pack_pair

        files = self._files
        path = files[index % len(files)]
        with np.load(path) as z:
            w0, w1, pairs = z["w0"], z["w1"], z["pairs"]
        with self._lock:
            visit = self._visits
            self._visits += 1
        rng = np.random.default_rng((self.seed, index, visit))
        if len(w0) + len(w1) > point_capacity:
            # oversized scene vs the runtime capacity (the reference
            # resamples pairs >50k points instead, ThreeDMatch.py:114-115):
            # 'crop' (default) takes a random full-density window around a
            # GT-pair anchor; 'subsample' thins points globally, keeping
            # up to num_corr correspondence pairs intact
            if self.fit_mode == "crop":
                w0, w1, pairs = crop_pair_to_budget(
                    rng, w0, w1, pairs, point_capacity)
            else:
                w0, w1, pairs = _subsample_pair_to_fit(
                    rng, w0, w1, pairs, point_capacity, self.num_corr)
        pts0, pts1, corr, dk = frame_scan_pair(
            rng, w0, w1, pairs, num_corr=self.num_corr, noise=self.noise,
            rotation=self.rotation, augment_rotation=self.augment_rotation,
            augment_translation=self.augment_translation)
        f0 = np.ones((len(pts0), 1), np.float32)
        f1 = np.ones((len(pts1), 1), np.float32)
        return pack_pair(
            pts0, pts1, f0, f1, corr, dk,
            point_capacity=point_capacity, corr_capacity=corr_capacity,
        )


class ScanPairDataset:
    """Loader-compatible dataset of simulated depth-scan pairs (realistic
    density; same interface as :class:`SyntheticPairDataset`)."""

    def __init__(self, size: int = 16, resolution=(160, 120),
                 num_corr: int = 128, seed: int = 0, downsample: float = 0.03):
        self.size = size
        self.resolution = resolution
        self.num_corr = num_corr
        self.seed = seed
        self.downsample = downsample

    def __len__(self) -> int:
        return self.size

    def packed(self, index: int, *, point_capacity: int, corr_capacity: int):
        from d3feat_tpu_torch.data.pack import pack_pair

        # rejection-sample scenes until the pair fits the static capacity
        # (fused scans of large rooms can exceed it); a final random
        # subsample bounds the loop — mirrors the reference protocol's
        # points_lim crop (reference: datasets/ThreeDMatch.py:27-43)
        for attempt in range(16):
            rng = np.random.default_rng(
                self.seed * 99991 + index + attempt * 7577791)
            pts0, pts1, corr, dk = scan_pair(
                rng, resolution=self.resolution, num_corr=self.num_corr,
                downsample=self.downsample,
            )
            if len(pts0) + len(pts1) <= point_capacity:
                break
        else:
            budget = point_capacity // 2
            keep0 = np.sort(rng.choice(
                len(pts0), size=min(len(pts0), budget), replace=False))
            keep1 = np.sort(rng.choice(
                len(pts1), size=min(len(pts1), budget), replace=False))
            inv0 = np.full(len(pts0), -1, np.int64)
            inv0[keep0] = np.arange(len(keep0))
            inv1 = np.full(len(pts1), -1, np.int64)
            inv1[keep1] = np.arange(len(keep1))
            corr = np.stack([inv0[corr[:, 0]], inv1[corr[:, 1]]], axis=1)
            corr = corr[(corr >= 0).all(axis=1)]
            if len(corr) == 0:  # degenerate: anchor a single trivial pair
                corr = np.zeros((1, 2), np.int64)
            pts0, pts1 = pts0[keep0], pts1[keep1]
            anc = pts0[corr[:, 0]]
            dk = np.linalg.norm(
                anc[:, None] - anc[None], axis=-1).astype(np.float32)
        f0 = np.ones((len(pts0), 1), np.float32)
        f1 = np.ones((len(pts1), 1), np.float32)
        return pack_pair(
            pts0, pts1, f0, f1, corr, dk,
            point_capacity=point_capacity, corr_capacity=corr_capacity,
        )
