"""Port vs JAX: the whole sorted-space pyramid from raw packed points.

Level-0 points are the packed points, so level 0 must match bit for bit.
Deeper levels are voxel barycenters whose last ulp may differ (the JAX
sort is unstable); lengths and overflow flags must still match exactly,
points within 1e-6, and a list may differ only in supports that sit on the
selection boundary (squared distance within 1e-6 relative of the JAX
threshold)."""

import numpy as np
import pytest
import torch

from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from tests.torch_port_helpers import jax_pyramid, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _port(seed):
    jcfg, (pts, _, lens), pyr = jax_pyramid(seed)
    tp = build_pyramid(torch.from_numpy(pts), torch.from_numpy(lens),
                       spec=make_pyramid_spec(torch_config(jcfg)))
    return pyr, tp


def _boundary_only(got, ref, q_pts, s_pts, thr):
    """Rows where the lists differ only by supports at d2 ~= thr."""
    for i in np.nonzero(np.any(got != ref, axis=1))[0]:
        diff = set(got[i].tolist()) ^ set(ref[i].tolist())
        diff.discard(len(s_pts))
        for p in diff:
            d2 = float(np.sum((s_pts[p].astype(np.float64) - q_pts[i]) ** 2))
            assert abs(d2 - thr[i]) <= 1e-6 * thr[i], (i, p, d2, thr[i])


@pytest.mark.parametrize("seed", [3, 5])
def test_pyramid_from_raw_points_matches_jax(seed):
    pyr, tp = _port(seed)
    assert bool(tp["overflow"]) == bool(pyr["overflow"]) is False
    for name, flag in pyr["overflow_by"].items():
        assert bool(tp["overflow_by"][name]) == bool(flag), name
    for l in range(5):
        assert np.array_equal(tp["lengths"][l].numpy(), pyr["lengths"][l])
        assert np.array_equal(tp["masks"][l].numpy(), pyr["masks"][l])
        np.testing.assert_allclose(tp["points"][l].numpy(), pyr["points"][l], rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 5])
def test_level0_is_bit_exact(seed):
    pyr, tp = _port(seed)
    assert np.array_equal(tp["points"][0].numpy(), pyr["points"][0])
    assert np.array_equal(tp["band"][0]["key_sorted"].numpy(), pyr["band"][0]["key_sorted"])
    assert np.array_equal(tp["band"][0]["order"].numpy(), pyr["band"][0]["order"])
    assert np.array_equal(tp["neighbors"][0].numpy(), pyr["neighbors"][0])
    for k in (0, 1):
        assert np.array_equal(tp["sel_thr"]["conv0"][k].numpy(), pyr["sel_thr"]["conv0"][k])


@pytest.mark.parametrize("seed", [3, 5])
def test_deeper_lists_differ_only_on_the_boundary(seed):
    pyr, tp = _port(seed)
    for l in range(1, 5):
        p = pyr["points"][l].astype(np.float64)
        _boundary_only(tp["neighbors"][l].numpy(), pyr["neighbors"][l], p, pyr["points"][l],
                       pyr["sel_thr"][f"conv{l}"][0])
    for l in range(4):
        q = pyr["points"][l + 1].astype(np.float64)
        _boundary_only(tp["pools"][l].numpy(), pyr["pools"][l], q, pyr["points"][l],
                       pyr["sel_thr"][f"pool{l}"][0])
        assert np.array_equal(tp["upsamples"][l].numpy(), pyr["upsamples"][l])


@pytest.mark.slow
def test_pyramid_matches_jitted_jax_on_eval_fragments():
    """The whole pyramid on a real pair (eval-cache group 10 at the bench
    capacities) against the jitted JAX band pyramid: lengths and overflow
    flags exact, points within 1e-6, level 0 bit for bit, deeper lists
    differing only on the selection boundary."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from d3feat_tpu.config import D3FeatConfig as JConfig, PyramidCaps as JCaps
    from d3feat_tpu.ops import build_pyramid as j_build_pyramid
    from d3feat_tpu.ops import make_pyramid_spec as j_make_pyramid_spec
    from tests.test_torch_subsample import EVAL_CAPS, _eval_group

    pts, lens = _eval_group()
    jcfg = JConfig(experiment_id="eval-group")
    jcfg.caps = JCaps(points=EVAL_CAPS, neighbors=(40,) * 5, corr=128)
    jspec = dataclasses.replace(j_make_pyramid_spec(jcfg, num_clouds=2), force_band_export=True)
    pyr = jax.jit(lambda p, n: j_build_pyramid(p, n, spec=jspec))(jnp.asarray(pts),
                                                                   jnp.asarray(lens))
    pyr = jax.tree.map(np.array, pyr)
    tp = build_pyramid(torch.from_numpy(pts), torch.from_numpy(lens),
                       spec=make_pyramid_spec(torch_config(jcfg)))
    assert bool(tp["overflow"]) == bool(pyr["overflow"]) is False
    for l in range(5):
        assert np.array_equal(tp["lengths"][l].numpy(), pyr["lengths"][l]), l
        np.testing.assert_allclose(tp["points"][l].numpy(), pyr["points"][l], rtol=0, atol=1e-6)
    assert np.array_equal(tp["neighbors"][0].numpy(), pyr["neighbors"][0])
    for l in range(1, 5):
        _boundary_only(tp["neighbors"][l].numpy(), pyr["neighbors"][l],
                       pyr["points"][l].astype(np.float64), pyr["points"][l],
                       pyr["sel_thr"][f"conv{l}"][0])
    for l in range(4):
        _boundary_only(tp["pools"][l].numpy(), pyr["pools"][l],
                       pyr["points"][l + 1].astype(np.float64), pyr["points"][l],
                       pyr["sel_thr"][f"pool{l}"][0])


def _equal(a, b):
    """``a`` and ``b`` hold the same structure and equal tensors, bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("search,impl", [("pallas", "auto"), ("pallas", "plain"),
                                         ("banded", "auto"), ("brute", "auto"),
                                         ("grid", "auto")])
def test_graph_path_stays_off_the_cpu_and_the_eager_routes(search, impl):
    """The CUDA graph is the band route's with K1's kernel on the card only:
    on the CPU, under ``impl="plain"`` and on the original-order routes
    ``build_pyramid`` captures and replays nothing and returns the eager
    build, bit for bit."""
    from d3feat_tpu_torch.ops import pyramid
    from tests.torch_port_helpers import jax_config, packed_pair

    cfg = torch_config(jax_config(3))
    cfg.neighbor_search = search
    spec = make_pyramid_spec(cfg)
    pts, _, lens = packed_pair(seed=3)
    pts, lens = torch.from_numpy(pts), torch.from_numpy(lens)
    before = (build_pyramid.launches_captured, build_pyramid.launches_replayed)
    got = build_pyramid(pts, lens, spec=spec, impl=impl)
    assert (build_pyramid.launches_captured, build_pyramid.launches_replayed) == before
    assert not pyramid._graphs
    assert _equal(got, pyramid._build_pyramid(pts, lens, spec, impl))
