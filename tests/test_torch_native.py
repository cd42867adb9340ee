"""Port vs JAX: the native C++ geometry ops. The port's own copy of
``geometry.cpp``, built by ``ops.build.build_host`` into
``d3feat_tpu_torch/_build/``, against the JAX package's ``native`` bit for
bit on the inputs of ``tests/test_native.py`` (``grid_subsample_batch``
with its overflow flag, ``radius_neighbors_batch``); ``data/prepare.py::
_nn_within`` on its native route against JAX's and against its own numpy
route; a failed build raising with the compiler's log."""

import os

import numpy as np
import pytest

import d3feat_tpu.data.prepare as JP
from d3feat_tpu import native as j_native
from d3feat_tpu_torch import native
from d3feat_tpu_torch.data import prepare as TP
from d3feat_tpu_torch.ops import build
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _stacked_pair(rng, n0=300, n1=250):
    """``tests/test_native.py::_stacked_pair``."""
    pts0 = rng.normal(size=(n0, 3)).astype(np.float32)
    pts1 = (rng.normal(size=(n1, 3)) + 0.5).astype(np.float32)
    return np.concatenate([pts0, pts1]), np.array([n0, n1], np.int32)


def test_library_is_the_ports_own():
    path = native.build()
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("host_geometry-")
    assert native.available() and native._load()._name == path
    assert os.path.realpath(path) != os.path.realpath(j_native.build())


@pytest.mark.parametrize("seed, voxel, capacity", [(0, 0.35, None), (1, 0.05, 10),
                                                   (5, 0.2, None)])
def test_grid_subsample_matches_jax(seed, voxel, capacity):
    pts, lens = _stacked_pair(np.random.default_rng(seed))
    got = native.grid_subsample_batch(pts, lens, voxel, capacity=capacity)
    want = j_native.grid_subsample_batch(pts, lens, voxel, capacity=capacity)
    assert got[2] == want[2] == (capacity is not None)  # the overflow flag
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["radius", "isolation", "xla"])
def test_radius_neighbors_matches_jax(case):
    if case == "radius":
        pts, lens = _stacked_pair(np.random.default_rng(2), 200, 180)
        r, k = 0.6, 12
    elif case == "isolation":  # two identical clouds stacked
        cloud = np.random.default_rng(3).normal(size=(100, 3)).astype(np.float32)
        pts, lens, r, k = np.concatenate([cloud, cloud]), np.array([100, 100], np.int32), 0.8, 8
    else:
        pts, lens = _stacked_pair(np.random.default_rng(4), 150, 120)
        r, k = 0.5, 10
    got = native.radius_neighbors_batch(pts, pts, lens, lens, r, k)
    want = j_native.radius_neighbors_batch(pts, pts, lens, lens, r, k)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert (got < len(pts)).any() and (got == len(pts)).any()


def test_nn_within_native_route():
    rng = np.random.default_rng(6)
    src = rng.uniform(0, 1, (2500, 3))
    tgt = src[rng.permutation(2500)[:2000]] + rng.normal(0, 0.004, (2000, 3))
    got = TP._nn_within(src, tgt, 0.02)
    want = JP._nn_within(src, tgt, 0.02, use_native=True)
    numpy_route = TP._nn_within(src, tgt, 0.02, use_native=False)
    assert got[1].sum() > 1000
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the numpy route: the same mask, the same targets where within (beyond
    # the threshold it keeps its argmin, the native route 0)
    ok = numpy_route[1]
    assert np.array_equal(got[1], ok) and np.array_equal(got[0][ok], numpy_route[0][ok])


def test_malformed_inputs_raise():
    pts, lens = _stacked_pair(np.random.default_rng(0))
    with pytest.raises(ValueError, match="do not fit"):
        native.grid_subsample_batch(pts, lens + 1, 0.35)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        native.radius_neighbors_batch(pts[:, :2], pts, lens, lens, 0.5, 4)
    with pytest.raises(ValueError, match="max_k"):
        native.radius_neighbors_batch(pts, pts, lens, lens[:1], 0.5, 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build.build_host(str(bad))

    def fail(*a, **k):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", fail)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):  # no fallback to numpy
        TP._nn_within(np.zeros((4, 3)), np.zeros((4, 3)), 0.1)
