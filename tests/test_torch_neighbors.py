"""Port vs JAX: sorted levels, banding frame and every pyramid search.

Given the JAX pyramid's own level points, the port's sorted levels and its
conv, pool and upsample searches (K1 twin) must reproduce the JAX lists,
thresholds and overflow flags bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.ops.neighbors import make_level_frame as j_frame
from d3feat_tpu_torch.ops.neighbors import SortedLevel, make_level_frame
from d3feat_tpu_torch.ops.pyramid import level_band_pad, level_search, make_pyramid_spec
from tests.torch_port_helpers import jax_pyramid, torch_config

SEED = 3


def _levels(seed=SEED):
    jcfg, _, pyr = jax_pyramid(seed)
    spec = make_pyramid_spec(torch_config(jcfg))
    pts0 = pyr["points"][0][pyr["band"][0]["inv"]]
    axis, origin = make_level_frame(torch.from_numpy(pts0),
                                    torch.from_numpy(pyr["lengths"][0]), 2)
    levels = []
    for l in range(spec.num_levels):
        p = torch.from_numpy(pyr["points"][l][pyr["band"][l]["inv"]])
        levels.append(SortedLevel(p, torch.from_numpy(pyr["lengths"][l]), 2, axis, origin,
                                  band_pad=level_band_pad(spec, l, p.shape[0])))
    return spec, pyr, (axis, origin), levels


@pytest.mark.parametrize("seed", [3, 5])
def test_level_frame_matches_jax(seed):
    _, _, pyr = jax_pyramid(seed)
    pts0 = np.array(pyr["points"][0][pyr["band"][0]["inv"]])
    ja, jo = j_frame(jnp.asarray(pts0), jnp.asarray(pyr["lengths"][0]), 2)
    ta, to = make_level_frame(torch.from_numpy(pts0),
                              torch.from_numpy(np.array(pyr["lengths"][0])), 2)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("l", range(5))
def test_sorted_level_matches_jax(l):
    _, pyr, _, levels = _levels()
    lv, b = levels[l], pyr["band"][l]
    assert np.array_equal(lv.key_sorted.numpy(), b["key_sorted"])
    assert np.array_equal(lv.order.numpy(), b["order"])
    assert np.array_equal(lv.inv.numpy(), b["inv"])
    assert np.array_equal(lv.q_rows.numpy(), b["q_packed"][:4].T)
    assert np.array_equal(lv.s_rows.numpy(), b["s_packed"][:, :4])


SEARCHES = [f"conv{l}" for l in range(5)] + [f"pool{l}" for l in range(4)] + \
    [f"up{l}" for l in range(4)]


@pytest.mark.parametrize("name", SEARCHES)
def test_search_matches_jax(name):
    spec, pyr, _, levels = _levels()
    kind, l = name[:-1], int(name[-1])
    r = spec.radii[l]
    if kind == "conv":
        res = level_search(levels[l], levels[l], r * spec.conv_r_scale[l],
                           spec.neighbor_caps[l], spec)
        ref = pyr["neighbors"][l]
    elif kind == "pool":
        res = level_search(levels[l + 1], levels[l], r * spec.pool_r_scale[l],
                           spec.neighbor_caps[l], spec)
        ref = pyr["pools"][l]
    else:
        res = level_search(levels[l], levels[l + 1], 2.0 * r, 1, spec)
        ref = pyr["upsamples"][l]
    assert res[0].dtype == torch.int32
    assert np.array_equal(res[0].numpy(), ref)
    assert bool(res[1]) == bool(pyr["overflow_by"][name])
    if kind != "up":
        jthr, jptie = pyr["sel_thr"][name]
        assert np.array_equal(res[2].numpy(), jthr)
        assert np.array_equal(res[3].numpy(), jptie)


def test_sorted_level_keys_match_jitted_jax_on_eval_fragments():
    """Level 0 of a real pair (eval-cache group 10): inside the jitted
    pyramid XLA compiles the key's projection ``sum(points * axis, 1)`` as a
    chain of fused multiply-adds; on a diagonal banding axis that moves the
    last bit of some keys, and with it the order of near-equal ones."""
    import jax

    from d3feat_tpu.ops.neighbors import SortedLevel as JSortedLevel
    from tests.test_torch_subsample import _eval_group

    pts, lens = _eval_group()
    axis, origin = make_level_frame(torch.from_numpy(pts), torch.from_numpy(lens), 2)
    assert bool((axis != 0).all(1).any())  # a diagonal axis: every coordinate counts

    def j_keys(p, n, a, o):
        lv = JSortedLevel(p, n, 2, a, o, band_pad=256)
        return lv.key_sorted, lv.order

    jkey, jorder = jax.jit(j_keys)(jnp.asarray(pts), jnp.asarray(lens),
                                   jnp.asarray(axis.numpy()), jnp.asarray(origin.numpy()))
    lv = SortedLevel(torch.from_numpy(pts), torch.from_numpy(lens), 2, axis, origin,
                     band_pad=256)
    assert np.array_equal(lv.key_sorted.numpy(), np.asarray(jkey))
    assert np.array_equal(lv.order.numpy(), np.asarray(jorder))
