"""Port vs JAX: the PLY reader and writer, the 3DMatch test set, feature
generation over it, the synthetic eval, and the two recall entry points
(``d3feat_tpu_torch.final_recall``, ``d3feat_tpu_torch.test_3dmatch``) on
the CPU at the small config of ``tests/torch_port_helpers.py`` (3
layers), the same weights carried across by ``params_from_numpy`` or the
portable npz. JAX extracts on the band route the port follows; every
extraction here runs at the 4096-row bucket, so one JAX program serves
the whole file."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import d3feat_tpu.data.ply as j_ply
import d3feat_tpu_torch.data.ply as t_ply
from d3feat_tpu.compat.portable import export_npz
from d3feat_tpu.data.synthetic import synthetic_fragment
from d3feat_tpu.data.threedmatch import ThreeDMatchTestset as JTestset
from d3feat_tpu.data.threedmatch import voxel_downsample
from d3feat_tpu.eval.extract import generate_features as j_generate
from d3feat_tpu.eval.registration import FragmentFeatures as JFeatures
from d3feat_tpu.eval.registration import register_scene as j_register
from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.data.threedmatch import ThreeDMatchTestset
from d3feat_tpu_torch.eval.extract import FeatureExtractor, generate_features
from d3feat_tpu_torch.eval.registration import FragmentFeatures
from d3feat_tpu_torch.eval.scene_cache import cache_path, save_scene
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from tests.torch_port_helpers import jax_band_extractor, jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

SCENES = ("scene-b", "scene-a")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX config, params, state, the port's model, the portable npz)."""
    jcfg = jax_config(3)
    params, state, _ = j_init(jax.random.key(7), jcfg)
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    npz = str(tmp_path_factory.mktemp("w") / "small.npz")
    export_npz(npz, params, state, meta={"config": jcfg.to_dict(), "epoch": 3})
    return jcfg, params, state, model, npz


# --- PLY ---


def _fields(rng, n=37):
    return ([rng.normal(size=(n, 3)).astype(np.float32), rng.random(n),
             rng.integers(0, 255, (n, 3)).astype(np.uint8), rng.integers(-5, 5, n)],
            ["x", "y", "z", "scalar", "red", "green", "blue", "label"])


def _same_ply(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ply_across_packages(tmp_path, writer):
    fields, names = _fields(np.random.default_rng(0))
    path = str(tmp_path / "f.ply")
    (j_ply if writer == "jax" else t_ply).write_ply(path, fields, names)
    other = str(tmp_path / "g.ply")
    (t_ply if writer == "jax" else j_ply).write_ply(other, fields, names)
    assert open(path, "rb").read() == open(other, "rb").read()
    _same_ply(t_ply.read_ply(path), j_ply.read_ply(path))
    pts = t_ply.read_ply_points(path)
    assert pts.dtype == np.float64 and np.array_equal(pts, j_ply.read_ply_points(path))
    assert np.array_equal(pts, fields[0].astype(np.float64))
    with pytest.raises(ValueError, match="columns"):
        t_ply.write_ply(path, fields, names[:-1])


@pytest.mark.parametrize("fmt", ["ascii", "binary_big_endian"])
def test_ply_formats_match_jax(tmp_path, fmt):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(20, 3)).astype(np.float32)
    header = ["ply", f"format {fmt} 1.0", "comment written by the test", "element vertex 20",
              "property float x", "property float y", "property float z",
              "element face 0", "property list uchar int vertex_indices", "end_header\n"]
    path = tmp_path / "f.ply"
    body = ("\n".join(" ".join(f"{v:.6f}" for v in r) for r in xyz).encode() + b"\n"
            if fmt == "ascii" else xyz.astype(">f4").tobytes())
    path.write_bytes("\n".join(header).encode() + body)
    _same_ply(t_ply.read_ply(str(path)), j_ply.read_ply(str(path)))
    assert np.array_equal(t_ply.read_ply_points(str(path)), j_ply.read_ply_points(str(path)))
    np.testing.assert_allclose(t_ply.read_ply_points(str(path)), xyz, atol=1e-6)
    (tmp_path / "bad.ply").write_bytes(b"not a ply\n")
    for pkg in (t_ply, j_ply):
        with pytest.raises(ValueError, match="not a PLY"):
            pkg.read_ply(str(tmp_path / "bad.ply"))


# --- the test set and feature generation ---


@pytest.fixture(scope="module")
def testset_root(tmp_path_factory):
    """<root>/fragments/<scene>/cloud_bin_<i>.ply: 2 scenes of 2 fragments,
    written by JAX's ``write_ply`` (fragment 1 first)."""
    root = tmp_path_factory.mktemp("3dmatch")
    rng = np.random.default_rng(2)
    for scene in SCENES:
        os.makedirs(root / "fragments" / scene)
        for i in (1, 0):
            pts = synthetic_fragment(rng, 1500, extent=2.0) @ np.diag([1.0, -1.0, 1.0])
            j_ply.write_ply(str(root / "fragments" / scene / f"cloud_bin_{i}.ply"),
                            [pts.astype(np.float32)], ["x", "y", "z"])
    return str(root)


def test_testset_matches_jax(testset_root):
    a = ThreeDMatchTestset(testset_root, downsample=0.1, scenes=SCENES)
    b = JTestset(testset_root, downsample=0.1, scenes=SCENES)
    assert a.fragment_paths == b.fragment_paths and a.scene_of == b.scene_of
    assert [os.path.basename(p) for p in a.fragment_paths] == ["cloud_bin_0.ply",
                                                                "cloud_bin_1.ply"] * 2
    assert a.scene_list == list(SCENES) and len(a) == 4 and a.num_fragments("scene-a") == 2
    for i in range(len(a)):
        x, y = a.get_fragment(i), b.get_fragment(i)
        assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
        assert 200 < len(x) < 4096


def test_generate_features_matches_jax(weights, testset_root, tmp_path):
    jcfg, params, state, model, _ = weights
    ts = ThreeDMatchTestset(testset_root, downsample=0.1, scenes=SCENES)
    got = generate_features(FeatureExtractor(torch_config(jcfg), model, device="cpu"), ts,
                            save_path=str(tmp_path / "port"))
    ref = j_generate(jax_band_extractor()(jcfg, params, state),
                     JTestset(testset_root, downsample=0.1, scenes=SCENES),
                     save_path=str(tmp_path / "jax"))
    assert list(got) == list(ref) == list(SCENES)
    for scene in SCENES:
        a, b = got[scene], ref[scene]
        assert a.num_fragments == b.num_fragments == 2
        for fid in range(2):
            assert np.array_equal(a.keypts[fid], b.keypts[fid])
            np.testing.assert_allclose(a.descriptors[fid], b.descriptors[fid], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(a.scores[fid], b.scores[fid], rtol=0, atol=1e-5)
            assert a.descriptors[fid].dtype == np.float32 and a.scores[fid].ndim == 1

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert len(tree(tmp_path / "port")) == 12
    for scene in SCENES:
        back = JFeatures.load(str(tmp_path / "port"), scene)
        for fid in range(2):
            assert np.array_equal(back.descriptors[fid], got[scene].descriptors[fid])
            assert np.array_equal(back.scores[fid], got[scene].scores[fid])


# --- the entry points ---


def _same_features(a, b, n):
    """The port's features within atol 1e-5 of JAX's (descriptors and
    scores; points exact) and the same top-``n`` keypoint sets."""
    from d3feat_tpu.eval.matching import select_keypoints

    assert a.num_fragments == b.num_fragments
    for fid in range(a.num_fragments):
        assert np.array_equal(a.keypts[fid], b.keypts[fid])
        np.testing.assert_allclose(a.descriptors[fid], b.descriptors[fid], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.scores[fid], b.scores[fid], rtol=0, atol=1e-5)
        assert set(select_keypoints(a.scores[fid], n)) == set(select_keypoints(b.scores[fid], n))


def _spy(monkeypatch, module, calls):
    """Record the features that ``module.register_scene`` is called with."""
    real = module.register_scene

    def spy(features, gt_log, **kw):
        calls.append((features, gt_log, kw))
        return real(features, gt_log, **kw)

    monkeypatch.setattr(module, "register_scene", spy)


def test_synthetic_eval_matches_jax(weights, capsys, monkeypatch):
    """The same fragments, features within 1e-5 of JAX's and the same
    recall; the inlier statistics are JAX's ``register_scene`` on the
    port's features (at these random weights the descriptors have
    near-ties, so features within 1e-7 of JAX's can give another
    mutual-NN pair)."""
    import d3feat_tpu.eval.extract as j_extract
    import d3feat_tpu.eval.registration as j_registration
    import d3feat_tpu_torch.eval.registration as t_registration
    import test_3dmatch
    from d3feat_tpu_torch import test_3dmatch as t_3dmatch

    jcfg, params, state, _, npz = weights
    monkeypatch.setattr(j_extract, "FeatureExtractor", jax_band_extractor())
    jcalls, tcalls = [], []
    _spy(monkeypatch, j_registration, jcalls)
    _spy(monkeypatch, t_registration, tcalls)
    assert test_3dmatch.synthetic_eval(test_3dmatch.parse_args(["--synthetic"]), jcfg,
                                       params, state) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_3dmatch.main(["--synthetic", "--cpu", "--snapshot", npz]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (tf, poses, kw), (jf, jposes, jkw) = tcalls[0], jcalls[0]
    assert kw == jkw and list(poses) == list(jposes) == ["0_1", "0_2", "1_2"]
    for k in poses:
        assert np.array_equal(poses[k], jposes[k])
    _same_features(tf, jf, kw["num_points"])
    assert got["scene"] == ref["scene"] == "synthetic" and got["recall"] == ref["recall"]
    res = j_register(tf, poses, **kw)
    assert got == {"scene": res.scene, "recall": res.recall,
                   "avg_inlier_ratio": res.avg_inlier_ratio, "avg_inlier_num": res.avg_inlier_num}


def test_final_recall_cli_matches_jax(weights, tmp_path, capsys, monkeypatch):
    """The CLI's recall equals JAX's on JAX's features; its JSON is JAX's
    ``register_scene`` on the port's features, which lie within 1e-5 of
    JAX's (see ``test_synthetic_eval_matches_jax`` for the near-ties)."""
    import d3feat_tpu_torch.eval.registration as t_registration
    from d3feat_tpu_torch import final_recall

    jcfg, params, state, _, npz = weights
    calls = []
    _spy(monkeypatch, t_registration, calls)
    rng = np.random.default_rng(3)
    base = voxel_downsample(synthetic_fragment(rng, 4000, extent=3.0), 0.1)
    frags, poses, frames = [], {}, []
    for f in range(3):
        rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        rot[:, 0] *= np.sign(np.linalg.det(rot))
        t = rng.normal(size=3) * 0.3
        frames.append((rot, t))
        frags.append(((base - t) @ rot).astype(np.float32))
    for i in range(3):
        for j in range(i + 1, 3):
            gt = np.eye(4)
            gt[:3, :3] = frames[i][0].T @ frames[j][0]
            gt[:3, 3] = (frames[j][1] - frames[i][1]) @ frames[i][0]
            poses[f"{i}_{j}"] = gt
    save_scene(cache_path(str(tmp_path), 11, 3, "axis", 2.0), frags, poses)

    out = tmp_path / "recall.json"
    assert final_recall.main(["--snapshot", npz, "--cpu", "--scene_cache", str(tmp_path),
                              "--seed", "11", "--scenes", "1", "--fragments", "3",
                              "--batch_fragments", "1", "--num_points", "100",
                              "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    got = json.loads(out.read_text())
    assert json.loads(printed[printed.index("{\n"):]) == got

    tf = calls[-1][0]  # the trained pass's features (the init pass comes first)
    jf = JFeatures()
    ex = jax_band_extractor()(jcfg, params, state, on_overflow="warn")
    for i, (desc, sc) in enumerate(ex.extract_many(frags)):
        jf.add(i, frags[i], desc, sc)
    _same_features(tf, jf, 100)
    ref = j_register(jf, poses, num_points=100)
    on_port = j_register(tf, poses, num_points=100)
    assert got["per_scene_recall"]["trained"]["per_scene_recall"] == [ref.recall]
    assert got["recall_trained"] == ref.recall == on_port.recall
    assert got["avg_inlier_ratio_trained"] == on_port.avg_inlier_ratio
    assert got["pair_inlier_ratios_trained"] == {
        "scene0": {k: round(v, 5) for k, v in on_port.pair_ratios.items()}}
    assert got["gt_pairs"] == 3 and got["overflow_warnings"] == {"scene0": []}
    assert got["card"] == "cpu" and got["compute_dtype"] == "float32"
    assert got["epochs_meta"] == {"epoch": 3} and got["recall_init"] is not None
    assert got["recall_gain"] == got["recall_trained"] - got["recall_init"]


def test_recall_entry_points_refuse(weights, tmp_path):
    from d3feat_tpu_torch import final_recall
    from d3feat_tpu_torch import test_3dmatch as t_3dmatch

    # a snapshot directory loads (tests/test_torch_train_cli.py); one
    # without the run's config.json is refused
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_3dmatch.main(["--synthetic", "--cpu", "--chosen_snapshot", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="torch_import"):
        t_3dmatch.main(["--synthetic", "--cpu", "--torch_checkpoint", "model.pth"])
    with pytest.raises(FileNotFoundError, match="config.json"):
        final_recall.main(["--cpu", "--snapshot", str(tmp_path)])
    if not torch.cuda.is_available():  # no silent CPU fallback
        for main, argv in ((final_recall.main, []), (t_3dmatch.main, ["--synthetic"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main(argv + ["--snapshot", weights[4]])
