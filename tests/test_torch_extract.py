"""Port vs JAX: the whole extraction step from raw packed points
(pyramid -> KPFCNN -> head, K1-K3 twins), and the port's FeatureExtractor
(buckets, fragment batching, overflow policy) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.eval.extract import _bucket_caps as j_bucket_caps
from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
from d3feat_tpu.ops import build_pyramid as j_build
from d3feat_tpu.train.step import make_extract_step as j_make_extract_step
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.data.pack import pack_fragments
from d3feat_tpu_torch.eval.extract import FeatureExtractor, _bucket_caps
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.train.step import make_extract_step
from tests.torch_port_helpers import jax_band_spec, jax_config, packed_pair, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def test_extract_step_matches_jax():
    jcfg = jax_config()
    params, state, specs = j_init(jax.random.key(5), jcfg)
    pts, feats, lens = packed_pair(seed=5)
    jf, js, jov = jax.jit(j_make_extract_step(jcfg, specs, pyramid_spec=jax_band_spec(jcfg)))(
        params, state, {"points": jnp.asarray(pts), "features": jnp.asarray(feats),
                        "lengths": jnp.asarray(lens)})
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    batch = {"points": torch.from_numpy(pts), "features": torch.from_numpy(feats),
             "lengths": torch.from_numpy(lens)}
    tf, ts, tov = make_extract_step(tcfg)(model, batch)

    # per-level lengths and overflow exact
    jpyr = j_build(jnp.asarray(pts), jnp.asarray(lens), spec=jax_band_spec(jcfg))
    tpyr = build_pyramid(batch["points"], batch["lengths"], spec=make_pyramid_spec(tcfg))
    for l in range(5):
        assert np.array_equal(tpyr["lengths"][l].numpy(), np.asarray(jpyr["lengths"][l]))
    assert bool(tov) == bool(jov) == bool(tpyr["overflow"]) is False
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    n = int(lens.sum())
    np.testing.assert_allclose(np.linalg.norm(tf.numpy()[:n], axis=1), 1.0, atol=1e-5)
    assert np.all(tf.numpy()[n:] == 0) and np.all(ts.numpy()[n:] == 0)


@pytest.mark.parametrize("cap0", [256, 512, 1024, 4096])
def test_bucket_caps_match_jax(cap0):
    jcfg = jax_config()
    j, t = j_bucket_caps(jcfg, cap0), _bucket_caps(torch_config(jcfg), cap0)
    assert (t.points, t.neighbors, t.corr) == (j.points, j.neighbors, j.corr)


def _extractor(buckets=(256, 512), **kw):
    tcfg = torch_config(jax_config())
    return FeatureExtractor(tcfg, init_kpfcnn(tcfg, device="cpu"), buckets=buckets,
                            device="cpu", **kw)


def _fragments():
    pts, _, lens = packed_pair(seed=3)
    return [pts[: lens[0]], pts[lens[0]: lens.sum()]]


def test_extract_many_equals_one_step():
    ex = _extractor(batch_fragments=2)
    frags = _fragments()
    got = ex.extract_many(frags)
    b = pack_fragments(frags, point_capacity=512, num_clouds=2)
    feats, scores, ov = ex._step_for(512, 2)(
        ex.model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert not bool(ov)
    n0 = len(frags[0])
    assert np.array_equal(got[0][0], feats[:n0].numpy())
    assert np.array_equal(got[1][1], scores[n0: n0 + len(frags[1]), 0].numpy())


def test_overflow_policy():
    frags = _fragments()
    with pytest.raises(RuntimeError, match="overflow"):
        _extractor(batch_fragments=2, on_overflow="raise", buckets=(128,)).extract_many(
            [f[:100] for f in frags])
    with pytest.warns(RuntimeWarning, match="overflow"):
        out = _extractor(batch_fragments=2, on_overflow="warn", buckets=(128,)).extract_many(
            [f[:100] for f in frags])
    assert len(out) == 2 and out[0][0].shape == (100, 32)
    # retry: the 128 bucket overflows, the 256 bucket does not
    retry = _extractor(batch_fragments=2, on_overflow="retry", buckets=(128, 256))
    out = retry.extract_many([f[:100] for f in frags])
    assert set(retry._steps) == {(256, 2), (512, 2)}
    assert np.isfinite(out[1][0]).all()
    with pytest.raises(ValueError):
        _extractor(on_overflow="ignore")


def test_extractor_requires_cuda_by_default():
    tcfg = torch_config(jax_config())
    model = init_kpfcnn(tcfg, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="not on"):
            FeatureExtractor(tcfg, model)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FeatureExtractor(tcfg, model)
