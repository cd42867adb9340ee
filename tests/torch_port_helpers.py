"""Shared inputs for the ``test_torch_*`` files: the same numpy inputs go
through the JAX package (Pallas kernels in interpret mode, as its own CPU
tests run them) and through the PyTorch port on the CPU.

Sizes follow ``tests/test_band_head.py``: 220 points per cloud, level-0
capacity 512, ``first_features_dim`` 16, ``force_band_export=True``.
"""

import dataclasses
import functools
import os

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


# --- registration recall on the held-out scenes: the JAX package's answer
# (``tests/torch_port_recall_r5.json``), which chip_smoke.py holds the card to ---

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5_NPZ = f"{ROOT}/artifacts/model_best_acc_r5.npz"
EVAL_CACHE = f"{ROOT}/artifacts/eval_cache"
RECALL_REFERENCE = f"{ROOT}/tests/torch_port_recall_r5.json"
RECALL_SEEDS = (424242, 424243, 424244, 424245)


def jax_r5():
    """(JAX config, params, model state) of the r5 npz, on its own config."""
    import json

    import jax
    from d3feat_tpu.compat.portable import import_npz
    from d3feat_tpu.config import D3FeatConfig
    from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init

    with np.load(R5_NPZ, allow_pickle=False) as z:
        cfg = D3FeatConfig.from_dict(json.loads(str(z["__meta__"]))["config"])
    params, state, _ = j_init(jax.random.key(0), cfg)
    params, state, _ = import_npz(R5_NPZ, params, state)
    return cfg, params, state


@functools.lru_cache(maxsize=None)
def _jax_band_step(cfg_json, cap0, num_clouds):
    import json

    import jax
    from d3feat_tpu.config import D3FeatConfig
    from d3feat_tpu.train.step import make_extract_step

    c = D3FeatConfig.from_dict(json.loads(cfg_json))
    return jax.jit(make_extract_step(c, pyramid_spec=jax_band_spec(c, num_clouds),
                                     num_clouds=num_clouds))


def jax_band_extractor():
    """JAX's ``FeatureExtractor`` class with every bucket's step on the band
    route the TPU ran and the port follows: ``make_extract_step`` on a
    pyramid spec with ``force_band_export`` (Pallas in interpret mode). The
    jitted steps are shared by every instance (the weights are arguments)."""
    import json

    from d3feat_tpu.config import D3FeatConfig
    from d3feat_tpu.eval.extract import FeatureExtractor, _bucket_caps

    class BandExtractor(FeatureExtractor):
        def _step_for(self, cap0, num_clouds):
            c = D3FeatConfig.from_dict(self.config.to_dict())
            c.caps = _bucket_caps(self.config, cap0)
            return _jax_band_step(json.dumps(c.to_dict(), sort_keys=True), cap0, num_clouds)

    return BandExtractor


def jax_scene_recall(ex, frags, poses, num_points=250):
    """One scene through JAX: ``extract_many`` group by group (overflow
    warnings caught per group), then ``register_scene``; per fragment the
    selected keypoints, per gt pair the correspondences and inliers."""
    import warnings

    from d3feat_tpu.eval.matching import inlier_stats, mutual_nn_numpy, select_keypoints
    from d3feat_tpu.eval.registration import FragmentFeatures, register_scene

    feats, frag_rows, groups = FragmentFeatures(), [], []
    b = ex.batch_fragments
    for g in range(0, len(frags), b):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = ex.extract_many(frags[g:g + b])
        over = [str(w.message) for w in caught if "overflow" in str(w.message)]
        if over:
            groups.append(g // b)
        for i, (desc, sc) in enumerate(out, start=g):
            feats.add(i, frags[i], desc, sc)
            frag_rows.append({"points": len(frags[i]), "group": g // b, "overflow": bool(over)})
    res = register_scene(feats, poses, num_points=num_points)
    sel = {}
    for i, row in enumerate(frag_rows):
        sel[i] = select_keypoints(feats.scores[i], num_points)
        row["top"] = sel[i].tolist()
    pairs = {}
    for key in poses:
        i, j = (int(v) for v in key.split("_"))
        corr = mutual_nn_numpy(np.nan_to_num(feats.descriptors[i][sel[i]]),
                               np.nan_to_num(feats.descriptors[j][sel[j]]))
        n_in, ratio = inlier_stats(feats.keypts[i][sel[i]], feats.keypts[j][sel[j]], corr,
                                   poses[key], 0.10)
        assert ratio == res.pair_ratios[key]
        pairs[key] = {"corr": int(len(corr)), "inliers": int(n_in), "ratio": float(ratio)}
    return {"gt_pairs": res.gt_pairs, "matched_pairs": res.matched_pairs,
            "recall": res.recall, "avg_inlier_ratio": res.avg_inlier_ratio,
            "overflowed_groups": groups, "fragments": frag_rows, "pairs": pairs}


def jax_recall_reference(seeds=RECALL_SEEDS, route="band"):
    """The JAX package's recall on the axis scenes ``seeds`` of the eval
    cache with the r5 weights: ``FeatureExtractor(batch_fragments=2,
    on_overflow="warn")`` on ``route`` (``"band"``: see ``jax_band_extractor``;
    ``"cpu"``: the package's own CPU route, XLA searches and the gather
    KPConv), 250 keypoints, 0.10, 5 %."""
    import sys
    import time

    import jax
    from d3feat_tpu.eval.extract import FeatureExtractor

    sys.path.insert(0, f"{ROOT}/tools")
    from scene_cache import cache_path, load_scene

    t = time.perf_counter()
    cfg, params, state = jax_r5()
    cls = jax_band_extractor() if route == "band" else FeatureExtractor
    ex = cls(cfg, params, state, batch_fragments=2, on_overflow="warn")
    scenes = {}
    for seed in seeds:
        frags, poses = load_scene(cache_path(EVAL_CACHE, seed, 12, "axis", 2.0))
        scenes[str(seed)] = jax_scene_recall(ex, frags, poses)
    route_doc = {"band": "make_extract_step on a pyramid spec with force_band_export=True "
                         "(the band route: K1-K3 as Pallas kernels in interpret mode)",
                 "cpu": "the JAX package's CPU route (tools/final_recall.py --cpu: XLA "
                        "banded searches, gather KPConv)"}[route]
    return {"meta": {"route": route, "route_detail": route_doc, "jax": jax.__version__,
                     "backend": jax.default_backend(), "seconds": time.perf_counter() - t,
                     "command": "JAX_PLATFORMS=cpu python -m tests.torch_port_helpers "
                                f"--route {route}",
                     "snapshot": "artifacts/model_best_acc_r5.npz",
                     "scene_cache": "artifacts/eval_cache", "frame": "axis", "warp": 2.0,
                     "fragments": 12, "batch_fragments": 2, "on_overflow": "warn",
                     "num_points": 250, "distance_threshold": 0.10,
                     "inlier_ratio_threshold": 0.05},
            "scenes": scenes}


def write_reference(ref, path):
    """JSON with one line per fragment and per pair."""
    import json
    import re

    text = json.dumps(ref, indent=1)
    text = re.sub(r"\[[-0-9.,\s]*\]", lambda m: re.sub(r"\s+", "", m.group(0)), text)
    text = re.sub(r'\{\s*("(?:points|corr)"[^{}]*?)\s*\}',
                  lambda m: "{" + re.sub(r"\s*\n\s*", " ", m.group(1)) + "}", text)
    with open(path, "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    import argparse
    import json

    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description="write the JAX recall reference")
    ap.add_argument("--route", choices=("band", "cpu"), default="band")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(RECALL_SEEDS))
    ap.add_argument("--out", default=RECALL_REFERENCE)
    a = ap.parse_args()
    ref = jax_recall_reference(tuple(a.seeds), a.route)
    write_reference(ref, a.out)
    for seed, s in ref["scenes"].items():
        print(seed, s["gt_pairs"], s["matched_pairs"], s["recall"], s["avg_inlier_ratio"],
              s["overflowed_groups"])
    print("seconds", ref["meta"]["seconds"])
