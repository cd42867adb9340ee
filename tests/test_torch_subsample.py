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
