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


# --- plain emulations of the kernels' list decomposition (K2 and K4 on the
# lists of ``ops.band_lists``), which the CUDA kernels compute on the card ---


def _bf16(t):
    return t.to(torch.bfloat16).float()


def weighted_from_lists(lists, q_rows, s_rows, x, kernel_points, extent, chunk=None,
                        starts=None, tile=None):
    """[Nq_pad, KP * Cin] first product per query over its listed rows:
    ``weighted[q, kp * Cin + c] = sum_j w_kp(q, lpos[q, j]) x[lpos[q, j], c]``.

    With ``chunk`` (the bf16 panels), x and the weights rounded to bf16, each
    list cut at the chunks of ``chunk`` rows from its tile's window start
    (``starts``, ``tile``), each piece rounded to bf16 and the pieces added
    in f32 (``S``): [2 * Nq_pad, KP * Cin], the rows ``bf16(S)`` then
    ``bf16(S - bf16(S))``."""
    from d3feat_tpu_torch.ops.band_conv import _BIG, kp_weights

    nq = q_rows.shape[0]
    valid = lists.lpos >= 0                                           # [Nq, L]
    pos = lists.lpos.clamp(min=0).long()
    d2m = torch.where(valid, lists.ld2, _BIG)[:, None, :]            # [Nq, 1, L]
    rows, q = s_rows[pos], q_rows[:, None, :]
    rnd = (lambda t: t) if chunk is None else _bf16
    xg = rnd(x)[pos] * valid[..., None]                               # [Nq, L, C]
    kpn = kernel_points.shape[0]
    w = [rnd(kp_weights(d2m, rows, q, kernel_points[k], extent)) for k in range(kpn)]
    if chunk is None:
        return torch.cat([torch.bmm(wk, xg) for wk in w], 1).reshape(nq, -1)
    ws = starts.long().repeat_interleave(tile)[:, None]
    cid = torch.where(valid, (pos - ws) // chunk, -1)
    total = torch.zeros((nq, kpn, x.shape[1]))
    for c in range(int(cid.max()) + 1):
        m = (cid == c).float()[:, None, :]
        total = total + _bf16(torch.cat([torch.bmm(wk * m, xg) for wk in w], 1))
    hi = _bf16(total)
    return torch.cat([hi.reshape(nq, -1), _bf16(total - hi).reshape(nq, -1)])


def band_conv_from_lists(lists, q_rows, s_rows, x, weights, kernel_points, extent, chunk=None,
                         starts=None, tile=None):
    """(out, den, weighted) of K2 from the lists: the first product, the
    density from the listed rows' feature sums, then ``weighted W / den``
    (with ``chunk``, the bf16 panels: ``(hi W + lo W) / den``)."""
    kpn, c, cout = weights.shape
    nq = q_rows.shape[0]
    wtd = weighted_from_lists(lists, q_rows, s_rows, x, kernel_points, extent, chunk, starts,
                              tile)
    rnd = (lambda t: t) if chunk is None else _bf16
    valid = lists.lpos >= 0
    active = (rnd(x).sum(-1) > 0.0)[lists.lpos.clamp(min=0).long()] & valid
    den = torch.clamp(active.sum(1).float(), min=1.0)
    wr = rnd(weights).reshape(kpn * c, cout)
    if chunk is None:
        out = (wtd @ wr) / den[:, None]
    else:
        out = (wtd[:nq] @ wr + wtd[nq:] @ wr) / den[:, None]
    return out, den, wtd


def band_conv_bwd_from_lists(lists, q_rows, s_rows, x, weights, kernel_points, gs, extent,
                             need_dx=True, chunk=None, starts=None, tile=None):
    """(dx or None, dW) of K4 from the lists: ``dW = weighted^T gs``, and
    ``G[r, kp] = sum_q w_kp(q, r) gs[q]`` gathered over the transposed
    lists (each support row's listed entries, ascending query order), then
    ``dx = G W^T``. With ``chunk`` (the bf16 panels): ``dW = hi^T gs + lo^T
    gs`` and ``dx[r] = sum_q sum_kp w_kp(q, r) V[q, kp]`` gathered over the
    same pairs, ``V = bf16(gs W^T)``, gs, W and the weights rounded to
    bf16."""
    from d3feat_tpu_torch.ops.band_conv import kp_weights
    from d3feat_tpu_torch.ops.band_lists import LCAP

    kpn, c, cout = weights.shape
    ns, nq = s_rows.shape[0], q_rows.shape[0]
    rnd = (lambda t: t) if chunk is None else _bf16
    wtd = weighted_from_lists(lists, q_rows, s_rows, x, kernel_points, extent, chunk, starts,
                              tile)
    gs = rnd(gs)
    if chunk is None:
        dw = (wtd.T @ gs).reshape(kpn, c, cout)
    else:
        dw = (wtd[:nq].T @ gs + wtd[nq:].T @ gs).reshape(kpn, c, cout)
    if not need_dx:
        return None, dw
    row_ptr, pairs = lists.transpose(ns)
    n_ent = int(row_ptr[-1])
    f = pairs[:n_ent].long()
    r = torch.repeat_interleave(torch.arange(ns, device=f.device),
                                (row_ptr[1:] - row_ptr[:-1]).long())
    qi = f // LCAP
    d2 = lists.ld2.reshape(-1)[f][:, None, None]                      # [E, 1, 1]
    rows, q = s_rows[r][:, None, :], q_rows[qi][:, None, :]
    w = torch.stack([rnd(kp_weights(d2, rows, q, kernel_points[k], extent))[:, 0, 0]
                     for k in range(kpn)], 1)                         # [E, KP]
    if chunk is not None:
        v = _bf16(gs @ _bf16(weights).reshape(kpn * c, cout).T).reshape(nq, kpn, c)
        return gs.new_zeros((ns, c)).index_add_(0, r, (w[:, :, None] * v[qi]).sum(1)), dw
    g_rows = gs.new_zeros((ns, kpn, cout)).index_add_(0, r, w[:, :, None] * gs[qi][:, None, :])
    dx = g_rows.reshape(ns, kpn * cout) @ weights.permute(0, 2, 1).reshape(kpn * cout, c)
    return dx, dw
