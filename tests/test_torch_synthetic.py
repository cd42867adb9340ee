"""The port's scan generator and voxel downsampling (numpy copies in
``d3feat_tpu_torch.data``) against the JAX package's, bit for bit: the
same ``np.random.Generator`` state gives the same fragment."""

import numpy as np
import pytest

from d3feat_tpu.data.synthetic import make_room as j_make_room
from d3feat_tpu.data.synthetic import scan_fragment as j_scan_fragment
from d3feat_tpu.data.threedmatch import voxel_downsample as j_voxel_downsample
from d3feat_tpu_torch.data.synthetic import make_room, scan_fragment
from d3feat_tpu_torch.data.threedmatch import voxel_downsample


@pytest.mark.parametrize("seed,resolution", [(0, (40, 30)), (7, (32, 24)), (3, (160, 120))])
def test_scan_fragment_bit_for_bit(seed, resolution):
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the generator states stay in step across draws
        want = j_scan_fragment(rng_j, resolution=resolution)
        got = scan_fragment(rng_t, resolution=resolution)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want) and len(got) > 100
    assert rng_j.random() == rng_t.random()


def test_make_room_bit_for_bit():
    a, b = j_make_room(np.random.default_rng(11)), make_room(np.random.default_rng(11))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert len(a[2]) == len(b[2])
    for oa, ob in zip(a[2], b[2]):
        assert oa[0] == ob[0]
        for u, v in zip(oa[1:], ob[1:]):
            assert np.array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("voxel", [0.03, 0.1])
def test_voxel_downsample_bit_for_bit(voxel):
    rng = np.random.default_rng(4)
    pts = (rng.uniform(-1.0, 2.0, size=(5000, 3)) * np.array([1.0, 0.5, 2.0])).astype(np.float32)
    pts[100:200] = pts[:100]  # repeated points share a voxel
    want, got = j_voxel_downsample(pts, voxel), voxel_downsample(pts, voxel)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want) and len(got) < len(pts)
    assert voxel_downsample(pts[:0], voxel).shape == (0, 3)
