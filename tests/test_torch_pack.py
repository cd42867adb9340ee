"""Port vs JAX: host packing and the eval-cache fragment loader."""

import numpy as np
import pytest

from d3feat_tpu.data import pack as jpack
from d3feat_tpu_torch.data import pack as tpack
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _clouds(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 3)).astype(np.float32) for n in sizes]


@pytest.mark.parametrize("sizes,cap,b", [((100, 80), 256, 2), ((5,), 8, 3), ((30, 0, 17), 64, 3)])
def test_pack_fragments_matches_jax(sizes, cap, b):
    clouds = _clouds(0, sizes)
    j = jpack.pack_fragments(clouds, point_capacity=cap, num_clouds=b)
    t = tpack.pack_fragments(clouds, point_capacity=cap, num_clouds=b)
    assert j.keys() == t.keys()
    for k in j:
        assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k


def test_pack_single_matches_jax():
    (c,) = _clouds(1, (70,))
    f = np.random.default_rng(2).uniform(size=(70, 2)).astype(np.float32)
    j = jpack.pack_single(c, f, point_capacity=128)
    t = tpack.pack_single(c, f, point_capacity=128)
    for k in j:
        assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
    assert tpack.SHADOW_COORD == jpack.SHADOW_COORD


def test_pack_capacity_errors():
    clouds = _clouds(3, (10, 10))
    with pytest.raises(ValueError):
        tpack.pack_fragments(clouds, point_capacity=15, num_clouds=2)
    with pytest.raises(ValueError):
        tpack.pack_fragments(clouds, point_capacity=64, num_clouds=1)
    with pytest.raises(ValueError):
        tpack.pack_single(clouds[0], np.ones((10, 1), np.float32), point_capacity=5)


@pytest.mark.parametrize("n", [1, 4096, 4097, 16384, 20000, 32768])
def test_choose_bucket_matches_jax(n):
    buckets = (4096, 8192, 16384, 32768)
    assert tpack.choose_bucket(n, buckets) == jpack.choose_bucket(n, buckets)


def test_choose_bucket_too_large():
    with pytest.raises(ValueError):
        tpack.choose_bucket(40000, (4096, 32768))


def test_eval_fragments_loader():
    frags = tpack.load_eval_fragments()
    assert len(frags) == 12 * 12
    assert all(f.dtype == np.float32 and f.ndim == 2 and f.shape[1] == 3 for f in frags)
    bench = tpack.load_eval_fragments(12000, 16000)
    assert len(bench) >= 2
    assert all(12000 <= len(f) <= 16000 for f in bench)
    with np.load(sorted(__import__("glob").glob(tpack.EVAL_CACHE + "/scene_*.npz"))[0]) as z:
        assert np.array_equal(frags[0], z["frag_0"]) and np.array_equal(frags[1], z["frag_1"])
