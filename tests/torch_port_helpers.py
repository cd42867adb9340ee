"""Shared inputs for the ``test_torch_*`` files: the same numpy inputs go
through the JAX package (Pallas kernels in interpret mode, as its own CPU
tests run them) and through the PyTorch port on the CPU.

Sizes follow ``tests/test_band_head.py``: 220 points per cloud, level-0
capacity 512, ``first_features_dim`` 16, ``force_band_export=True``.
"""

import dataclasses
import functools

import numpy as np
import torch

N_POINTS = 220
CAPS = (512, 256, 128, 64, 32)
NEIGHBORS = 14


def jax_config(num_layers=5, **overrides):
    from d3feat_tpu.config import D3FeatConfig, PyramidCaps

    cfg = D3FeatConfig(experiment_id="port-test")
    cfg.num_layers = num_layers
    cfg.first_features_dim = 16
    cfg.first_subsampling_dl = 0.1
    cfg.caps = PyramidCaps(points=CAPS[:num_layers], neighbors=(NEIGHBORS,) * num_layers,
                           corr=8)
    cfg.query_tile = 128
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def torch_config(jcfg):
    from d3feat_tpu_torch.config import D3FeatConfig

    return D3FeatConfig.from_dict(jcfg.to_dict())


def packed_pair(seed=3, n=N_POINTS, cap=CAPS[0]):
    """Packed numpy pair (points [cap, 3], features [cap, 1], lengths [2])."""
    from d3feat_tpu.data.pack import pack_pair
    from d3feat_tpu.data.synthetic import synthetic_pair

    rng = np.random.default_rng(seed)
    pts0, pts1, corr, dk = synthetic_pair(rng, n_points=n, num_corr=8, extent=2.0)
    packed = pack_pair(pts0, pts1, np.ones((n, 1), np.float32),
                       np.ones((n, 1), np.float32), corr, dk,
                       point_capacity=cap, corr_capacity=8)
    return packed.points, packed.features, packed.lengths


def pair_batch(seed=3, n=N_POINTS, cap=CAPS[0]):
    """The packed numpy training pair of ``packed_pair(seed)`` with its
    correspondences: the six arrays of a train-step batch."""
    from d3feat_tpu.data.pack import pack_pair
    from d3feat_tpu.data.synthetic import synthetic_pair

    rng = np.random.default_rng(seed)
    pts0, pts1, corr, dk = synthetic_pair(rng, n_points=n, num_corr=8, extent=2.0)
    p = pack_pair(pts0, pts1, np.ones((n, 1), np.float32), np.ones((n, 1), np.float32),
                  corr, dk, point_capacity=cap, corr_capacity=8)
    return {k: getattr(p, k) for k in
            ("points", "features", "lengths", "corr", "corr_valid", "dist_keypts")}


def jax_band_spec(jcfg, num_clouds=2):
    from d3feat_tpu.ops import make_pyramid_spec

    return dataclasses.replace(make_pyramid_spec(jcfg, num_clouds=num_clouds),
                               force_band_export=True)


@functools.lru_cache(maxsize=None)
def jax_pyramid(seed=3, num_layers=5):
    """(jax config, packed numpy inputs, numpy copy of the JAX band pyramid)."""
    import jax
    import jax.numpy as jnp
    from d3feat_tpu.ops import build_pyramid

    jcfg = jax_config(num_layers)
    points, features, lengths = packed_pair(seed)
    pyr = build_pyramid(jnp.asarray(points), jnp.asarray(lengths),
                        spec=jax_band_spec(jcfg))
    return jcfg, (points, features, lengths), jax.tree.map(np.array, pyr)


def torch_batch_from_jax(pyr, features_sorted):
    """The port's sorted-space batch dict rebuilt from a numpy JAX band
    pyramid: same level points, lists and thresholds; ``[N, 4]`` rows."""
    from d3feat_tpu_torch.ops.neighbors import SHADOW_LIKE

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    num_clouds = len(pyr["lengths"][0])
    band = {}
    for l, b in pyr["band"].items():
        q = b["q_packed"][:4].T.copy()
        s = b["s_packed"][:, :4].copy()
        n = q.shape[0]
        assert np.all(s[n:, :3] == np.float32(SHADOW_LIKE)) and np.all(s[n:, 3] == num_clouds)
        band[l] = {"key_sorted": t(b["key_sorted"]), "order": t(b["order"]).long(),
                   "inv": t(b["inv"]).long(), "q_rows": t(q), "s_rows": t(s)}
    return {
        "points": [t(p) for p in pyr["points"]],
        "neighbors": [t(x) for x in pyr["neighbors"]],
        "pools": [t(x) for x in pyr["pools"]],
        "upsamples": [t(x) for x in pyr["upsamples"]],
        "lengths": [t(x) for x in pyr["lengths"]],
        "masks": [t(x) for x in pyr["masks"]],
        "band": band,
        "sel_thr": {k: (t(a), t(b)) for k, (a, b) in pyr["sel_thr"].items()},
        "overflow": t(pyr["overflow"]),
        "features": t(np.asarray(features_sorted, np.float32)),
    }
