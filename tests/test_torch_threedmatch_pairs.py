"""Port vs JAX: the 3DMatch training data path on files the test writes
(the download is not in the repository): ``prepare_split`` from fragment
PLYs and a gt log against the JAX package's, on its numpy route (JAX's
native neighbour search switched off from the test side) and on both
packages' native route, pickles equal byte for byte; ``compute_correspondences`` with and without the mutual filter; then
``ThreeDMatchPairDataset.get_pair`` and ``packed`` draw for draw,
including ``self_augment``, the oversize resample (``max_points``) and the
capacity resample (``point_capacity``)."""

import functools
import os
import pickle

import numpy as np
import pytest

import d3feat_tpu.data.prepare as JP
import d3feat_tpu_torch.data.prepare as TP
from d3feat_tpu.data.threedmatch import ThreeDMatchPairDataset as JDataset
from d3feat_tpu_torch.data.ply import write_ply
from d3feat_tpu_torch.data.synthetic import synthetic_fragment
from d3feat_tpu_torch.data.threedmatch import ThreeDMatchPairDataset as TDataset
from d3feat_tpu_torch.eval.gtlog import save_gt_log
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


SCENES = ("scene-a", "scene-b")
DOWNSAMPLE = 0.05


def _frames(rng, n):
    out = []
    for _ in range(n):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(rot) < 0:
            rot[:, 0] *= -1
        out.append((rot, rng.normal(size=3) * 0.3))
    return out


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """Per scene: 4 overlapping windows of one synthetic surface, each in its
    own frame, as PLY, and the gt log of every pair (scene-b's log in the
    ``<scene>-evaluation`` directory)."""
    root = str(tmp_path_factory.mktemp("3dmatch"))
    rng = np.random.default_rng(0)
    for s, scene in enumerate(SCENES):
        base = synthetic_fragment(rng, 6000 + 1500 * s, extent=3.0).astype(np.float64)
        frames = _frames(rng, 4)
        d = os.path.join(root, "fragments", scene)
        os.makedirs(d)
        for i, (rot, t) in enumerate(frames):
            window = base[(base[:, 0] > 0.4 * i) & (base[:, 0] < 0.4 * i + 1.6)]
            write_ply(os.path.join(d, f"cloud_bin_{i}.ply"), [(window - t) @ rot],
                      ["x", "y", "z"])
        poses = {}
        for i in range(4):
            for j in range(i + 1, 4):
                (ri, ti), (rj, tj) = frames[i], frames[j]
                gt = np.eye(4)
                gt[:3, :3] = ri.T @ rj
                gt[:3, 3] = (tj - ti) @ ri
                poses[f"{i}_{j}"] = gt
        log_dir = d if s == 0 else os.path.join(root, f"{scene}-evaluation")
        os.makedirs(log_dir, exist_ok=True)
        save_gt_log(os.path.join(log_dir, "gt.log"), poses, 4)
    return root


@pytest.fixture(scope="module", params=["numpy", "native"])
def prepared(request, raw_root, tmp_path_factory):
    """(JAX's pickle paths, the port's) for the train split, the
    correspondence search on one route in both packages: numpy (JAX's
    native search switched off from the test side, the port's by
    ``use_native=False``) or native (both packages' defaults)."""
    out = {}
    use_native = request.param == "native"
    orig = JP._nn_within
    if not use_native:
        JP._nn_within = functools.partial(orig, use_native=False)
    try:
        for tag, mod, kw in (("jax", JP, {}), ("port", TP, {"use_native": use_native})):
            out[tag] = mod.prepare_split(raw_root, SCENES, split="train", downsample=DOWNSAMPLE,
                                         out_dir=str(tmp_path_factory.mktemp(tag)), **kw)
    finally:
        JP._nn_within = orig
    return out


def test_prepare_split_matches_jax(prepared):
    for a, b in zip(prepared["jax"], prepared["port"]):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(a)
    with open(prepared["port"][1], "rb") as f:
        keypts = pickle.load(f)
    assert len(keypts) >= 8 and min(len(v) for v in keypts.values()) > 0


@pytest.mark.parametrize("mutual", [True, False])
def test_compute_correspondences(mutual):
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 1, (3000, 3))
    tgt = src[rng.permutation(3000)[:2500]] + rng.normal(0, 0.004, (2500, 3))
    trans = np.eye(4)
    trans[:3, 3] = [0.01, -0.02, 0.0]
    tgt = tgt - trans[:3, 3]
    a = JP.compute_correspondences(src, tgt, trans, 0.02, mutual=mutual)
    b = TP.compute_correspondences(src, tgt, trans, 0.02, mutual=mutual)
    assert a.dtype == b.dtype and len(b) > 100
    np.testing.assert_array_equal(a, b)


def _datasets(prepared, **kw):
    root = os.path.dirname(prepared["port"][0])
    return (JDataset(root, split="train", downsample=DOWNSAMPLE, num_node=32, **kw),
            TDataset(root, split="train", downsample=DOWNSAMPLE, num_node=32, **kw))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(seed=1), dict(seed=2, self_augment=True),
                                dict(seed=3, max_points=2000)])
def test_get_pair_matches_jax(prepared, kw):
    j, t = _datasets(prepared, **kw)
    assert len(j) == len(t) and t.src_ids == j.src_ids
    sizes = sorted(len(p) for p in t.points)
    if "max_points" in kw:  # some fragments are over the limit: those draws resample
        assert sizes[0] <= kw["max_points"] < sizes[-1]
    for _ in range(2):
        for i in range(len(t)):
            _same(j.get_pair(i), t.get_pair(i))
    assert j.rng.random() == t.rng.random()


def test_packed_matches_jax(prepared):
    j, t = _datasets(prepared, seed=4)
    sizes = sorted(len(p) for p in t.points)
    cap = sizes[len(sizes) // 2] * 2  # about half the pairs exceed it and resample
    for i in range(len(t)):
        a = j.packed(i, point_capacity=cap, corr_capacity=32)
        b = t.packed(i, point_capacity=cap, corr_capacity=32)
        _same(a, b)
        assert int(b.lengths.sum()) <= cap
    assert j.rng.random() == t.rng.random()
