"""Port vs JAX: the pair generators and datasets of ``data/synthetic.py``,
host numpy copied draw for draw, so the same seeds give the same arrays bit
for bit: ``synthetic_pair`` and ``SyntheticPairDataset``, ``scan_pair_world``
(with and without the warp field) at a small camera resolution,
``frame_scan_pair`` in each rotation mode, both fit functions,
``DiskScanPairDataset`` on scene files the test writes (roles, crop and
subsample, two visits of one index) and ``ScanPairDataset`` (its
subsample branch after 16 rejected draws at a tiny capacity)."""

import os

import numpy as np
import pytest

import d3feat_tpu.data.synthetic as J
import d3feat_tpu_torch.data.synthetic as T
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


RES = (40, 30)  # camera resolution: usable scenes within a few draws, 4-7k points a pair


def assert_same(a, b):
    """Equal arrays (or tuples / NamedTuples of them), dtypes included."""
    if isinstance(a, tuple):
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def both(name, seed, *args, **kw):
    """(JAX's, the port's) result of ``name`` on equal fresh generators,
    plus each generator's next draw (the draws they consumed agree)."""
    out = []
    for mod in (J, T):
        rng = np.random.default_rng(seed)
        out.append((getattr(mod, name)(rng, *args, **kw), rng.random()))
    assert out[0][1] == out[1][1]
    return out[0][0], out[1][0]


@pytest.fixture(scope="module")
def scene():
    """One small world-frame scene (JAX's draw; the port's is tested equal)."""
    return J.scan_pair_world(np.random.default_rng(11), resolution=RES, max_corr=256)


def test_synthetic_pair_and_dataset():
    assert_same(*both("synthetic_pair", 3, n_points=300, num_corr=16, extent=2.0))
    assert_same(*both("synthetic_pair", 4, n_points=200, num_corr=8, augment_noise=0.01,
                      augment_axis=0, augment_rotation=0.5, augment_translation=1.0))
    kw = dict(size=4, n_points=220, num_corr=8, seed=5)
    j, t = J.SyntheticPairDataset(**kw), T.SyntheticPairDataset(**kw)
    assert len(j) == len(t) == 4
    for i in range(4):
        assert_same(j.packed(i, point_capacity=512, corr_capacity=16),
                    t.packed(i, point_capacity=512, corr_capacity=16))


@pytest.mark.parametrize("warp", [0.0, 1.5])
def test_scan_pair_world(warp):
    j, t = both("scan_pair_world", 11 + int(warp), resolution=RES, max_corr=64, warp=warp)
    assert_same(j, t)
    assert len(j[0]) >= 256 and len(j[1]) >= 256 and 8 <= len(j[2]) <= 64


@pytest.mark.parametrize("rotation", ["axis", "axis2", "mix", "so3"])
def test_frame_scan_pair(scene, rotation):
    for seed in (0, 1, 2):
        j, t = both("frame_scan_pair", seed, *scene, num_corr=32, noise=0.005,
                    rotation=rotation, augment_rotation=0.7, augment_translation=0.3)
        assert_same(j, t)
        assert j[2].shape == (32, 2)


def test_scan_pair():
    assert_same(*both("scan_pair", 21, resolution=RES, num_corr=16))


def test_fit_functions(scene):
    w0, w1, pairs = scene
    budget = (len(w0) + len(w1)) // 2
    j, t = both("crop_pair_to_budget", 1, w0, w1, pairs, budget)
    assert_same(j, t)
    assert len(j[0]) + len(j[1]) <= budget and len(j[2]) > 0
    j, t = both("_subsample_pair_to_fit", 2, w0, w1, pairs, 600, 16)
    assert_same(j, t)
    assert len(j[0]) + len(j[1]) <= 600
    with pytest.raises(ValueError):
        T._subsample_pair_to_fit(np.random.default_rng(0), w0, w1, pairs, 256, 16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, scene):
    """Scene files 0, 1, 2, 50 (0 and 50 of the validation role) of 4300-6900
    points a pair: capacity 8192 fits them, 1200 crops or subsamples."""
    root = tmp_path_factory.mktemp("corpus")
    for i in (0, 1, 2, 50):
        w0, w1, pairs = J.scan_pair_world(np.random.default_rng(100 + i), resolution=RES,
                                          max_corr=256)
        np.savez(os.path.join(root, f"scene_{i:06d}.npz"), w0=w0, w1=w1, pairs=pairs)
    os.makedirs(os.path.join(root, "not_a_scene"))
    np.savez(os.path.join(root, ".tmp_000003.1.npz"), w0=w0, w1=w1, pairs=pairs)
    return str(root)


@pytest.mark.parametrize("role,fit_mode,cap", [("all", "crop", 8192), ("train", "crop", 1200),
                                               ("val", "subsample", 1200)])
def test_disk_dataset(corpus, role, fit_mode, cap):
    kw = dict(num_corr=32, seed=3, noise=0.005, role=role, rotation="mix", fit_mode=fit_mode)
    j, t = J.DiskScanPairDataset(corpus, **kw), T.DiskScanPairDataset(corpus, **kw)
    assert len(j) == len(t) == {"all": 4, "train": 2, "val": 2}[role]
    assert [os.path.basename(p) for p in t._files] == [os.path.basename(p) for p in j._files]
    first = None
    for visit in range(2):
        for i in range(len(t)):
            a = j.packed(i, point_capacity=cap, corr_capacity=32)
            b = t.packed(i, point_capacity=cap, corr_capacity=32)
            assert_same(a, b)
            if i == 0 and visit == 0:
                first = b
            if i == 0 and visit == 1:  # a second visit of one index is another pair
                assert not np.array_equal(first.points, b.points)
    assert j._visits == t._visits == 2 * len(t)


def test_disk_dataset_needs_scenes(tmp_path):
    with pytest.raises(FileNotFoundError):
        T.DiskScanPairDataset(str(tmp_path))


@pytest.mark.parametrize("cap", [8192, 600])
def test_scan_dataset(cap):
    """At 600 points no draw fits: the subsample branch after 16 draws."""
    kw = dict(size=2, resolution=RES, num_corr=16, seed=2)
    j, t = J.ScanPairDataset(**kw), T.ScanPairDataset(**kw)
    for i in range(2):
        a = j.packed(i, point_capacity=cap, corr_capacity=16)
        assert_same(a, t.packed(i, point_capacity=cap, corr_capacity=16))
        assert int(a.lengths.sum()) <= cap
