"""Simulated depth-scan fragments (port of the scan generator of
``d3feat_tpu.data.synthetic``): rooms of rotated boxes, spheres and capped
cylinders, rendered by a pinhole depth camera with Kinect-like noise, fused
over a few nearby views and voxel-downsampled at the dataset resolution.
The bench draws its fragments from ``scan_fragment``; the held-out scene
generator (``eval/scene_cache.py``) warps its rooms with
``make_warp_field``, and the synthetic eval draws ``synthetic_fragment``.

Host numpy, copied draw for draw: the same ``np.random.Generator`` state
gives the JAX package's fragment bit for bit. The pair generators and
datasets are not ported yet.
"""

from __future__ import annotations

import numpy as np

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
