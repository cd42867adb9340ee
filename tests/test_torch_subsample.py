"""Port vs JAX: voxel subsampling. Lengths and overflow must be exact;
barycenters agree within 1e-6 (the JAX sort is unstable, so the order of
points inside a voxel, and with it the last ulp of a sum, may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops import subsample as jsub
from d3feat_tpu_torch.ops import subsample as tsub
from tests.torch_port_helpers import packed_pair
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _stack(seed, sizes, scale=2.0, cap=None):
    rng = np.random.default_rng(seed)
    clouds = [(rng.uniform(0, 1, size=(n, 3)) * scale + rng.normal(size=3)).astype(np.float32)
              for n in sizes]
    cap = cap or sum(sizes) + 64
    pts = np.full((cap, 3), 1.0e6, np.float32)
    pts[: sum(sizes)] = np.concatenate(clouds)
    return pts, np.array(sizes, np.int32)


def _compare(pts, lens, dl, cap, occ=64, points=True):
    j = jsub.voxel_subsample(jnp.asarray(pts), jnp.asarray(lens), dl, out_capacity=cap,
                             num_clouds=len(lens), occupancy_cap=occ)
    t = tsub.voxel_subsample(torch.from_numpy(pts), torch.from_numpy(lens), dl,
                             out_capacity=cap, num_clouds=len(lens), occupancy_cap=occ)
    assert np.array_equal(np.asarray(j.lengths), t.lengths.numpy())
    assert bool(j.overflow) == bool(t.overflow)
    assert np.array_equal(np.asarray(j.valid), t.valid.numpy())
    if points:
        np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), rtol=0, atol=1e-6)
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dl", [0.1, 0.25, 0.6])
def test_voxel_subsample_matches_jax(seed, dl):
    pts, lens = _stack(seed, (300, 170))
    t = _compare(pts, lens, dl, 512)
    assert not bool(t.overflow)


@pytest.mark.parametrize("seed", [3, 5])
def test_voxel_subsample_scan_pair(seed):
    pts, _, lens = packed_pair(seed)
    _compare(pts, lens, 0.2, 256)


def test_voxel_overflow_capacity_and_window():
    pts, lens = _stack(4, (400, 100))
    t = _compare(pts, lens, 0.05, 64)             # too many voxels
    assert bool(t.overflow)
    dense, dlens = _stack(6, (200,), scale=0.01)
    # one voxel, run > window: its sum covers an order-dependent subset of
    # the run in both stacks, so only the flag and the lengths compare
    t = _compare(dense, dlens, 1.0, 16, occ=32, points=False)
    assert bool(t.overflow) and int(t.lengths[0]) == 1


@pytest.mark.parametrize("lengths", [(5, 3), (0, 7), (8, 0, 0), (1, 1, 1)])
def test_cloud_ids_and_mask_match_jax(lengths):
    lens = np.array(lengths, np.int32)
    n = int(lens.sum()) + 3
    assert np.array_equal(tsub.lengths_to_cloud_ids(torch.from_numpy(lens), n).numpy(),
                          np.asarray(jsub.lengths_to_cloud_ids(jnp.asarray(lens), n)))
    assert np.array_equal(tsub.lengths_to_mask(torch.from_numpy(lens), n).numpy(),
                          np.asarray(jsub.lengths_to_mask(jnp.asarray(lens), n)))


# --- against the reference as it runs: jitted, the voxel size a constant ---

EVAL_GROUP = 10  # eval-cache fragments 20 and 21, paired as chip_smoke pairs them
EVAL_CAPS = tuple(2 * c for c in (16384, 8192, 2048, 768, 256))  # the bench capacities


def _eval_group(group=EVAL_GROUP):
    from d3feat_tpu_torch.data.pack import load_eval_fragments, pack_fragments

    frags = load_eval_fragments(12000, 16000)
    b = pack_fragments(frags[2 * group:2 * group + 2], point_capacity=EVAL_CAPS[0],
                       num_clouds=2)
    return b["points"], b["lengths"]


def test_voxel_subsample_matches_jitted_jax_on_eval_fragments():
    """Level 0 -> 1 (voxel 0.06) on a real pair: XLA compiles ``/ dl`` as a
    multiply by ``1 / dl``, which moves points that lie on a voxel plane
    into the next voxel; the port must bin them as the jitted reference."""
    import functools

    import jax

    pts, lens = _eval_group()
    dl = 0.06
    jfn = jax.jit(functools.partial(jsub.voxel_subsample, voxel_size=dl,
                                    out_capacity=EVAL_CAPS[1], num_clouds=2, occupancy_cap=64))
    j = jfn(jnp.asarray(pts), jnp.asarray(lens))
    t = tsub.voxel_subsample(torch.from_numpy(pts), torch.from_numpy(lens), dl,
                             out_capacity=EVAL_CAPS[1], num_clouds=2, occupancy_cap=64)
    assert np.asarray(j.lengths).tolist() == t.lengths.tolist()
    assert bool(j.overflow) == bool(t.overflow) is False
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), rtol=0, atol=1e-6)


def _pre_change_voxel_subsample(points, lengths, voxel_size, *, out_capacity, num_clouds,
                                occupancy_cap=64, divide=False):
    """``voxel_subsample`` as it computed before its constants became host
    scalars: ``dl``, ``1 / dl`` and the shadow coordinate as 0-dim float32
    tensors on the points' device."""
    n, b, dev = points.shape[0], num_clouds, points.device
    dl = torch.tensor(float(voxel_size), dtype=torch.float32, device=dev)
    inv_dl = torch.tensor(1.0, dtype=torch.float32, device=dev) / dl
    cid = tsub.lengths_to_cloud_ids(lengths, n)
    valid = cid < b
    big = torch.tensor(tsub.SHADOW_COORD, dtype=torch.float32, device=dev)
    mins = torch.stack([torch.where((cid == c)[:, None], points, big).amin(0)
                        for c in range(b)])
    cid_c = torch.clamp(cid, max=b - 1).long()
    scale = (lambda v: v / dl) if divide else (lambda v: v * inv_dl)
    origin = torch.floor(scale(mins)) * dl
    rel = scale(points - origin[cid_c])
    cell = torch.clamp(torch.floor(rel).to(torch.int32), 0, (1 << 16) - 1).long()
    k_lo = cell[:, 0] | (cell[:, 1] << 16)
    k_hi = cell[:, 2] | (cid.long() << 16)
    key = torch.where(valid, (k_hi << 32) | k_lo, torch.full_like(k_lo, (1 << 63) - 1))
    key_s, order = torch.sort(key, stable=True)
    s_pts = points[order]
    s_valid = key_s != (1 << 63) - 1
    s_cid = torch.where(s_valid, key_s >> 48, torch.full_like(key_s, b))
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(is_first.to(torch.int64), 0) - 1
    c = out_capacity
    run_ids = torch.arange(c, device=dev)
    steps = max(1, (occupancy_cap - 1).bit_length())
    vals = torch.cat([s_pts.float(), torch.ones(n, 1, device=dev)], 1)
    for sft in (1 << t for t in range(steps)):
        if sft >= n:
            break
        same = seg[sft:] == seg[:-sft]
        vals = torch.cat([vals[:sft], vals[sft:] + torch.where(same[:, None], vals[:-sft], 0.0)])
    ends = torch.searchsorted(seg, run_ids, right=True)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    last = torch.clamp(ends - 1, min=0)
    n_unique = (is_first & s_valid).sum()
    out_slot_valid = run_ids < torch.clamp(n_unique, max=c)
    occ_overflow = torch.where(out_slot_valid, ends - starts, 0).max() > (1 << steps)
    bary = vals[last, :3] / torch.clamp((ends - starts).to(torch.float32), min=1.0)[:, None]
    out_cid = torch.where(out_slot_valid, s_cid[last], torch.full_like(last, b))
    return tsub.SubsampleResult(
        points=torch.where(out_slot_valid[:, None], bary, big).float(),
        lengths=torch.stack([(out_cid == c_).sum() for c_ in range(b)]).to(torch.int32),
        valid=out_slot_valid, overflow=(n_unique > c) | occ_overflow)


@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("dl", [0.03, 0.06, 0.15])
def test_voxel_subsample_on_voxel_planes_is_unchanged(dl, divide):
    """Two clouds of 220 points whose coordinates are float32 multiples of
    the voxel size, so every point lies on or next to a voxel plane and
    the rounding of each scaling decides its voxel: the outputs equal the
    pre-change arithmetic's bit for bit, with ``divide`` and without (which
    bin some of these points apart)."""
    rng = np.random.default_rng(7)
    m = rng.integers(0, 24, size=(440, 3)) + np.array([[0, 0, 0]] * 220 + [[-31, 5, 77]] * 220)
    cap = 512
    pts = np.full((cap, 3), 1.0e6, np.float32)
    pts[:440] = (m * np.float32(dl)).astype(np.float32)
    lens = np.array([220, 220], np.int32)
    args = (torch.from_numpy(pts), torch.from_numpy(lens), dl)
    kw = dict(out_capacity=cap, num_clouds=2, occupancy_cap=8)
    got = tsub.voxel_subsample(*args, divide=divide, **kw)
    want = _pre_change_voxel_subsample(*args, divide=divide, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    other = tsub.voxel_subsample(*args, divide=not divide, **kw)
    assert not torch.equal(got.points, other.points)
