"""Port vs JAX: registration eval (gt logs, keypoint selection, mutual-NN,
inlier counts, scene recall, the features' on-disk layout) and the
meters. The port's counterpart of every case in ``tests/test_eval.py``,
then each function against the JAX package's on the same seeded inputs."""

import os
import time
import warnings
from dataclasses import asdict

import numpy as np
import pytest
import torch

import d3feat_tpu.eval as J
import d3feat_tpu.utils.timer as j_timer
import d3feat_tpu_torch.eval as T
from d3feat_tpu_torch.eval.matching import mutual_nn_matrix
from d3feat_tpu_torch.utils.timer import AverageMeter, Timer
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _make_scene(pkg, rng, n_frag=3, n_pts=120, d=32):
    """Fragments sharing one global point set; descriptors are noisy copies
    of per-point signatures, so mutual-NN recovers the true matching (the
    scene of ``tests/test_eval.py``, stored in ``pkg``'s FragmentFeatures)."""
    world = rng.normal(size=(n_pts, 3))
    sigs = _unit(rng.normal(size=(n_pts, d)))
    feats = pkg.FragmentFeatures()
    poses, frames = {}, []
    for f in range(n_frag):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(rot) < 0:
            rot[:, 0] *= -1
        t = rng.normal(size=3)
        frames.append((rot, t))
        local = (world - t) @ rot
        desc = _unit(sigs + 0.02 * rng.normal(size=sigs.shape))
        feats.add(f, local, desc, rng.random(n_pts))
    for i in range(n_frag):
        for j in range(i + 1, n_frag):
            ri, ti = frames[i]
            rj, tj = frames[j]
            gt = np.eye(4)
            gt[:3, :3] = ri.T @ rj
            gt[:3, 3] = (tj - ti) @ ri
            poses[f"{i}_{j}"] = gt
    return feats, poses


def _noisy_scene(pkg, seed, noise):
    """A scene whose descriptors are partly destroyed, so that some pairs
    match and some do not."""
    rng = np.random.default_rng(seed)
    feats, poses = _make_scene(pkg, rng, n_frag=4, n_pts=160)
    for f in feats.descriptors:
        d = feats.descriptors[f]
        feats.descriptors[f] = _unit(d + noise * rng.normal(size=d.shape)).astype(np.float32)
    return feats, poses


# --- the port's counterparts of tests/test_eval.py ---


def test_gtlog_roundtrip(tmp_path):
    poses = {
        "0_1": np.eye(4) + 0.01 * np.arange(16).reshape(4, 4),
        "2_5": np.linalg.qr(np.random.default_rng(0).normal(size=(4, 4)))[0],
    }
    T.save_gt_log(str(tmp_path / "gt.log"), poses, num_frags=7)
    loaded = T.load_gt_log(str(tmp_path))
    assert set(loaded) == set(poses)
    for k in poses:
        np.testing.assert_allclose(loaded[k], poses[k], atol=1e-6)


def test_mutual_nn_identity():
    desc = _unit(np.random.default_rng(0).normal(size=(50, 32)))
    corr = T.mutual_nn_numpy(desc, desc)
    assert len(corr) == 50
    np.testing.assert_array_equal(corr[:, 0], corr[:, 1])


def test_mutual_nn_device_matches_numpy():
    rng = np.random.default_rng(1)
    s = _unit(rng.normal(size=(64, 32)))
    t = _unit(rng.normal(size=(80, 32)))
    np.testing.assert_array_equal(T.mutual_nn_numpy(s, t), T.mutual_nn(s, t, device="cpu"))


def test_select_keypoints_top_scores():
    assert set(T.select_keypoints(np.array([0.1, 0.9, 0.5, 0.7, 0.2]), 2)) == {1, 3}


def test_select_keypoints_short_guard():
    scores = np.array([0.0, 0.9, 0.0, 0.7, 0.0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert set(T.select_keypoints(scores, 2)) == {1, 3}
    with pytest.warns(RuntimeWarning, match="positive-score"):
        T.select_keypoints(scores, 3)
    with pytest.raises(RuntimeError, match="positive-score"):
        T.select_keypoints(scores, 3, on_short="raise")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.select_keypoints(scores, 3, on_short="ignore")


def test_inlier_stats_exact_pose():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(30, 3))
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(rot) < 0:
        rot[:, 0] *= -1
    trans = np.array([0.3, -0.2, 0.1])
    tgt = (src - trans) @ rot
    gt = np.eye(4)
    gt[:3, :3] = rot
    gt[:3, 3] = trans
    corr = np.stack([np.arange(30), np.arange(30)], axis=1)
    assert T.inlier_stats(src, tgt, corr, gt, 0.10) == (30, 1.0)


def test_register_scene_perfect_features():
    feats, poses = _make_scene(T, np.random.default_rng(3))
    res = T.register_scene(feats, poses, scene="synthetic", num_points=100)
    assert res.gt_pairs == 3 and res.recall == 100.0 and res.avg_inlier_ratio > 0.5


def test_register_scene_random_features_fail():
    rng = np.random.default_rng(4)
    feats, poses = _make_scene(T, rng)
    for f in feats.descriptors:
        feats.descriptors[f] = _unit(rng.normal(size=feats.descriptors[f].shape))
    res = T.register_scene(feats, poses, scene="broken", num_points=100)
    assert res.recall < 100.0 and res.avg_inlier_ratio < 0.2


def test_evaluate_scenes_and_disk_roundtrip(tmp_path):
    feats, poses = _make_scene(T, np.random.default_rng(5))
    scene = "scene-a"
    os.makedirs(tmp_path / f"{scene}-evaluation")
    T.save_gt_log(str(tmp_path / f"{scene}-evaluation" / "gt.log"), poses)
    feats.save(str(tmp_path / "features"), scene)
    reloaded = T.FragmentFeatures.load(str(tmp_path / "features"), scene)
    assert reloaded.num_fragments == feats.num_fragments
    results, summary = T.evaluate_scenes({scene: reloaded}, str(tmp_path), num_points=100)
    assert results[0].recall == 100.0 and summary["avg_recall"] == 100.0


# --- port vs JAX on the same seeded inputs ---


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_keypoints_matches_jax(seed):
    rng = np.random.default_rng(seed)
    scores = rng.random(400).astype(np.float32)
    scores[rng.random(400) < 0.5] = 0.0           # undetected points
    scores[:40] = scores[40:80]                    # equal scores
    for k in (10, 150):
        np.testing.assert_array_equal(T.select_keypoints(scores, k),
                                      J.select_keypoints(scores, k))
    a = T.select_keypoints(scores[:, None], 50, random=True, rng=np.random.default_rng(seed))
    b = J.select_keypoints(scores[:, None], 50, random=True, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(a, b)
    short = int((scores > 0).sum()) + 1            # the guard: fewer positives than k
    for pkg in (T, J):
        with pytest.warns(RuntimeWarning, match=f"only {short - 1} positive-score"):
            got = pkg.select_keypoints(scores, short)
        np.testing.assert_array_equal(got, J.select_keypoints(scores, short, on_short="ignore"))
        with pytest.raises(RuntimeError, match=f"only {short - 1} positive-score"):
            pkg.select_keypoints(scores, short, on_short="raise")


def _descs(seed, ns=120, nt=140, dup=True):
    rng = np.random.default_rng(seed)
    s = _unit(rng.normal(size=(ns, 32))).astype(np.float32)
    t = _unit(s[rng.permutation(ns)[: nt // 2]] + 0.1 * rng.normal(size=(nt // 2, 32)))
    t = np.concatenate([t, _unit(rng.normal(size=(nt - nt // 2, 32)))]).astype(np.float32)
    if dup:  # exact ties: duplicated source and target rows
        s[5] = s[17]
        s[60] = s[3]
        t[9] = t[30]
        t[100] = t[2]
    return s, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutual_nn_numpy_matches_jax(seed):
    s, t = _descs(seed)
    np.testing.assert_array_equal(T.mutual_nn_numpy(s, t), J.mutual_nn_numpy(s, t))


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_mutual_nn_torch_matches_jax(seed, dup):
    from d3feat_tpu.eval.matching import mutual_nn_matrix as j_matrix

    s, t = _descs(seed, dup=dup)
    s_nn, mutual = mutual_nn_matrix(torch.from_numpy(s), torch.from_numpy(t))
    j_nn, j_mut = j_matrix(s, t)
    np.testing.assert_array_equal(s_nn.numpy(), np.asarray(j_nn))
    np.testing.assert_array_equal(mutual.numpy(), np.asarray(j_mut))
    got = T.mutual_nn(s, t, device="cpu")
    np.testing.assert_array_equal(got, J.mutual_nn(s, t))
    assert len(got) > 10


@pytest.mark.parametrize("seed", [0, 1])
def test_inlier_stats_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, tgt = rng.normal(size=(60, 3)), rng.normal(size=(70, 3)) * 0.3
    corr = np.stack([rng.integers(0, 60, 50), rng.integers(0, 70, 50)], 1)
    gt = np.eye(4)
    gt[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    gt[:3, 3] = rng.normal(size=3) * 0.1
    for thr in (0.1, 0.5, 1.0):
        a, b = T.inlier_stats(src, tgt, corr, gt, thr), J.inlier_stats(src, tgt, corr, gt, thr)
        assert a == b and type(a[0]) is type(b[0]) is int
    assert T.inlier_stats(src, tgt, corr[:0], gt, 0.1) == J.inlier_stats(src, tgt, corr[:0],
                                                                          gt, 0.1) == (0, 0.0)


@pytest.mark.parametrize("random_points", [False, True])
@pytest.mark.parametrize("seed", [6, 7])
def test_register_scene_matches_jax(seed, random_points):
    tf, poses = _noisy_scene(T, seed, 0.6)
    jf, _ = _noisy_scene(J, seed, 0.6)
    kw = dict(scene="s", num_points=80, random_points=random_points, seed=seed)
    a, b = T.register_scene(tf, poses, **kw), J.register_scene(jf, poses, **kw)
    assert asdict(a) == asdict(b)       # every field, pair_ratios included
    assert 0 < len(a.pair_ratios) == a.gt_pairs == 6


def test_evaluate_scenes_matches_jax(tmp_path):
    features = {}
    for k, (scene, seed) in enumerate((("scene-a", 8), ("scene-b", 9))):
        feats, poses = _noisy_scene(T, seed, 0.5 + 0.2 * k)
        os.makedirs(tmp_path / f"{scene}-evaluation")
        T.save_gt_log(str(tmp_path / f"{scene}-evaluation" / "gt.log"), poses, num_frags=4)
        features[scene] = feats
    kw = dict(num_points=90, inlier_ratio_threshold=0.1, distance_threshold=0.2)
    ra, sa = T.evaluate_scenes(features, str(tmp_path), **kw)
    rb, sb = J.evaluate_scenes(features, str(tmp_path), **kw)
    assert [asdict(r) for r in ra] == [asdict(r) for r in rb] and sa == sb


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fragment_features_layout_across_packages(tmp_path, writer):
    feats, _ = _make_scene(T if writer == "port" else J, np.random.default_rng(10))
    feats.descriptors[1][3, 5] = np.nan  # loaded as 0 (nan_to_num, test.py:48-49)
    feats.save(str(tmp_path), "scene-x", "D3Feat")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                   for d, _, fs in os.walk(tmp_path) for f in fs)
    assert files == sorted(f"{sub}/scene-x/cloud_bin_{i}{ext}.npy" for i in range(3)
                           for sub, ext in (("keypoints", ""), ("descriptors", ".D3Feat"),
                                            ("scores", "")))
    a = T.FragmentFeatures.load(str(tmp_path), "scene-x")
    b = J.FragmentFeatures.load(str(tmp_path), "scene-x")
    assert a.num_fragments == b.num_fragments == 3
    for fid in range(3):
        for name in ("keypts", "descriptors", "scores"):
            x, y = getattr(a, name)[fid], getattr(b, name)[fid]
            assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.descriptors[1][3, 5] == 0.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_gtlog_across_packages(tmp_path, writer):
    rng = np.random.default_rng(11)
    poses = {}
    for key in ("0_1", "0_4", "3_12"):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3)
        poses[key] = pose
    (T if writer == "port" else J).save_gt_log(str(tmp_path / "gt.log"), poses, num_frags=13)
    other = J if writer == "port" else T
    assert open(tmp_path / "gt.log").read().splitlines()[0] == "0\t1\t13"
    a, b = T.load_gt_log(str(tmp_path)), other.load_gt_log(str(tmp_path / "gt.log"))
    assert list(a) == list(b) == list(poses)
    for k in poses:
        assert np.array_equal(a[k], b[k])
        np.testing.assert_allclose(a[k], poses[k], atol=5e-9)


def test_meters_match_jax():
    a, b = AverageMeter(), j_timer.AverageMeter()
    for v, n in ((1.5, 1), (2.0, 3), (-0.25, 2)):
        a.update(v, n)
        b.update(v, n)
    assert vars(a) == vars(b) and a.var == b.var and a.count == 6
    assert AverageMeter().var == 0.0
    t = Timer()
    t.tic()
    time.sleep(0.01)
    first = t.toc(average=False)
    t.tic()
    avg = t.toc()
    assert first >= 0.01 and t.calls == 2 and avg == pytest.approx(t.total_time / 2)
    assert set(vars(t)) == set(vars(j_timer.Timer()))
