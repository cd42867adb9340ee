"""Port vs JAX: ``PairLoader``, batch for batch on the same dataset and seed
(``num_devices`` 1 and 2, shuffled, the wrap-around fill of the last
group), its length under ``drop_last`` and ``max_iter``, a worker's
exception raised in the consumer, and an abandoned iteration stopping its
producer thread."""

import threading
import time

import numpy as np
import pytest

from d3feat_tpu.data.loader import PairLoader as JPairLoader
from d3feat_tpu.data.synthetic import SyntheticPairDataset as JSynthetic
from d3feat_tpu_torch.data.loader import PairLoader, _to_batch_dict
from d3feat_tpu_torch.data.synthetic import SyntheticPairDataset
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


KEYS = ("points", "features", "lengths", "corr", "corr_valid", "dist_keypts")


def _loaders(size, **kw):
    ds = dict(size=size, n_points=220, num_corr=8, seed=4)
    args = dict(point_capacity=512, corr_capacity=8, num_workers=2, seed=9, **kw)
    return JPairLoader(JSynthetic(**ds), **args), PairLoader(SyntheticPairDataset(**ds), **args)


@pytest.mark.parametrize("num_devices,drop_last", [(1, True), (2, True), (2, False)])
def test_batches_match_jax(num_devices, drop_last):
    j, t = _loaders(5, num_devices=num_devices, drop_last=drop_last)
    assert len(j) == len(t) == (5 // num_devices if drop_last else 3)
    for epoch in range(2):  # the shuffle generator advances per epoch on both sides
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == len(t)
        for a, b in zip(jb, tb):
            assert tuple(b) == KEYS
            for k in KEYS:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].shape[0] == num_devices
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_len_and_max_iter():
    ds = SyntheticPairDataset(size=7, n_points=220, num_corr=8)
    mk = lambda **kw: PairLoader(ds, point_capacity=512, corr_capacity=8, **kw)  # noqa: E731
    assert len(mk()) == 7
    assert len(mk(num_devices=2)) == 3
    assert len(mk(num_devices=2, drop_last=False)) == 4
    assert len(mk(num_devices=2, drop_last=False, max_iter=2)) == 2
    assert len(mk(max_iter=10)) == 7
    loader = mk(num_devices=3, drop_last=False, shuffle=False, max_iter=3)
    batches = list(loader)
    assert len(batches) == 3
    # the last group (index 6) is filled from the epoch's first indices (0, 1)
    first = _to_batch_dict(ds.packed(0, point_capacity=512, corr_capacity=8))
    np.testing.assert_array_equal(batches[2]["points"][1], first["points"])


class _Boom:
    def __len__(self):
        return 4

    def packed(self, index, *, point_capacity, corr_capacity):
        raise ValueError("synthetic failure")


def test_worker_error_reaches_the_consumer():
    loader = PairLoader(_Boom(), point_capacity=64, corr_capacity=8, num_workers=2, max_iter=2)
    with pytest.raises(ValueError, match="synthetic failure"):
        list(loader)


def test_abandoned_iteration_stops_the_producer():
    before = set(threading.enumerate())
    loader = PairLoader(SyntheticPairDataset(size=32, n_points=220, num_corr=8),
                        point_capacity=512, corr_capacity=8, num_workers=2, prefetch=1)
    it = iter(loader)
    next(it)
    started = [t for t in threading.enumerate() if t not in before]
    assert started, "no producer thread"
    it.close()
    deadline = time.monotonic() + 10.0
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in started)
