"""Shared inputs for the ``test_torch_*`` files: the same numpy inputs go
through the JAX package (Pallas kernels in interpret mode, as its own CPU
tests run them) and through the PyTorch port on the CPU.

Sizes follow ``tests/test_band_head.py``: 220 points per cloud, level-0
capacity 512, ``first_features_dim`` 16, ``force_band_export=True``.
"""

import contextlib
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

N_POINTS = 220
CAPS = (512, 256, 128, 64, 32)
NEIGHBORS = 14


@contextlib.contextmanager
def one_torch_thread():
    """Run torch's CPU ops on one thread inside the block. The suite runs in
    several worker processes on a few cores: every torch op spread over all
    cores by every worker oversubscribes them, and the waiting threads slow
    every worker (a 5 s test took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread_module():
    """``one_torch_thread`` around every test of a module that imports this
    fixture."""
    with one_torch_thread():
        yield


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


def torch_batch_from_jax_original(pyr):
    """The port's batch dict of a numpy JAX original-order pyramid."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    out = {k: [t(a) for a in pyr[k]]
           for k in ("points", "neighbors", "pools", "upsamples", "lengths", "masks")}
    return dict(out, band={}, sel_thr={}, overflow=t(pyr["overflow"]))


# --- plain emulations of the kernels' list decomposition (K2 and K4 on the
# lists of ``ops.band_lists``), which the CUDA kernels compute on the card ---


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _entry_weights(lists, ld2, valid, rows, q, k, extent):
    """[n, T, L] influence of kernel point ``k`` on the listed pairs of
    support rows ``rows`` [n, L, 4] and queries ``q`` [n, T, 4], 0 where not
    ``valid`` [n, T, L], by the rule of the lists' mode: threshold mode from
    the entries' exact d2 ``ld2`` [n, T, L], list mode from the coordinates
    alone."""
    from d3feat_tpu_torch.ops.band_conv import _BIG, kp_weights, list_weights

    if lists.mode == "list":
        return list_weights(rows[:, None], q[:, :, None], k, extent) * valid
    return kp_weights(torch.where(valid, ld2, _BIG), rows, q, k, extent)


def weighted_from_lists(lists, q_rows, s_rows, x, kernel_points, extent, chunk=None,
                        starts=None, tile=None):
    """[Nq_pad, KP * Cin] first product per query over its listed rows:
    ``weighted[q, kp * Cin + c] = sum_j w_kp(q, lpos[q, j]) x[lpos[q, j], c]``.

    With ``chunk`` (the bf16 panels), x and the weights rounded to bf16, each
    list cut at the chunks of ``chunk`` rows from its tile's window start
    (``starts``, ``tile``), each piece rounded to bf16 and the pieces added
    in f32 (``S``): [2 * Nq_pad, KP * Cin], the rows ``bf16(S)`` then
    ``bf16(S - bf16(S))``."""
    nq = q_rows.shape[0]
    valid = lists.lpos >= 0                                           # [Nq, L]
    pos = lists.lpos.clamp(min=0).long()
    ld2 = None if lists.ld2 is None else lists.ld2[:, None, :]        # [Nq, 1, L]
    rows, q = s_rows[pos], q_rows[:, None, :]
    rnd = (lambda t: t) if chunk is None else _bf16
    xg = rnd(x)[pos] * valid[..., None]                               # [Nq, L, C]
    kpn = kernel_points.shape[0]
    w = [rnd(_entry_weights(lists, ld2, valid[:, None, :], rows, q, kernel_points[k], extent))
         for k in range(kpn)]
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
    qi = f // lists.width
    d2 = None if lists.ld2 is None else lists.ld2.reshape(-1)[f][:, None, None]  # [E, 1, 1]
    rows, q = s_rows[r][:, None, :], q_rows[qi][:, None, :]
    every = torch.ones((f.shape[0], 1, 1), dtype=torch.bool)
    w = torch.stack([rnd(_entry_weights(lists, d2, every, rows, q, kernel_points[k],
                                        extent))[:, 0, 0] for k in range(kpn)], 1)  # [E, KP]
    if chunk is not None:
        v = _bf16(gs @ _bf16(weights).reshape(kpn * c, cout).T).reshape(nq, kpn, c)
        return gs.new_zeros((ns, c)).index_add_(0, r, (w[:, :, None] * v[qi]).sum(1)), dw
    g_rows = gs.new_zeros((ns, kpn, cout)).index_add_(0, r, w[:, :, None] * gs[qi][:, None, :])
    dx = g_rows.reshape(ns, kpn * cout) @ weights.permute(0, 2, 1).reshape(kpn * cout, c)
    return dx, dw


# --- the bf16 kernels' route (band_products.cuh, band_conv_bwd.cu), emulated
# step by step: the pieces by ballot, the products of bf16 operands with the
# tensor cores' truncating additions, K4's dx by pairs ---


def _rz(x):
    """float64 -> float32 rounded toward zero: a tensor-core addition."""
    y = x.astype(np.float32)
    return np.where(np.abs(y) > np.abs(x), np.nextafter(y, np.float32(0)), y)


def bf16_rn(a):
    """float32 -> bfloat16 (as float32) rounded to nearest even by its bits,
    as ``__float2bfloat16_rn`` rounds (finite values)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def piece_starts_serial(lpos, lcnt, ws, chunk):
    """[Nq, L] bool, the first entry of each piece of each list (the
    entries of one chunk of ``chunk`` rows from the window start ``ws[q]``):
    the serial scan that every lane ran before, ``j1`` advanced while the
    chunk id equals the piece's first entry's."""
    lpos, lcnt, ws = np.asarray(lpos), np.asarray(lcnt), np.asarray(ws)
    first = np.zeros(lpos.shape, bool)
    for qi in range(lpos.shape[0]):
        n, j0 = int(lcnt[qi]), 0
        while j0 < n:
            first[qi, j0] = True
            cid = (lpos[qi, j0] - ws[qi]) // chunk
            j1 = j0 + 1
            while j1 < n and (lpos[qi, j1] - ws[qi]) // chunk == cid:
                j1 += 1
            j0 = j1
    return first


def piece_starts_ballot(lpos, lcnt, ws, chunk):
    """The same from ``weighted_bf16_kernel``'s ballots: lane l holds entries
    l + 32 h (h < L / 32), their chunk ids (-1 past the count); ``shfl_up``
    gives each lane the previous lane's id in word h, lane 0 takes entry 32
    h - 1's (``shfl`` from lane 31 of word h - 1; in word 0 its own); a lane
    votes for an entry below the count that is entry 0 or whose id differs
    from the previous one. Returns the L / 32 ballots as bools."""
    lpos, lcnt = np.asarray(lpos, np.int64), np.asarray(lcnt)
    lane = np.arange(32)
    valid = np.arange(lpos.shape[1])[None, :] < lcnt[:, None]
    cid = np.where(valid, (lpos - np.asarray(ws)[:, None]) // chunk, -1)
    votes, last = [], None
    for h in range(lpos.shape[1] // 32):
        c = cid[:, 32 * h:32 * h + 32]
        lane0 = c[:, :1] if last is None else last                 # word 0: lane 0 keeps its own
        prev = np.concatenate([lane0, c[:, :-1]], 1)
        votes.append(valid[:, 32 * h:32 * h + 32]
                     & (((lane == 0) & (h == 0))[None, :] | (c != prev)))
        last = c[:, 31:32]
    return np.concatenate(votes, 1)


def pieces_of(first, n):
    """[(j0, j1), ...] of a list of ``n`` entries from its first-entry mask,
    walked as the kernel walks it (the next set bit above j0, else n)."""
    bits = sum(1 << int(j) for j in np.flatnonzero(first))
    out, j0 = [], 0
    while j0 < n:
        later = bits >> (j0 + 1)
        j1 = min(j0 + 1 + (later & -later).bit_length() - 1, n) if later else n
        out.append((j0, j1))
        j0 = j1
    return out


def mma_bf16_two_staged(a, a2, b):
    """``gemm_bf16_kernel``'s product of bf16 operands (float32 arrays of
    bf16 values) ``a b + a2 b`` (``a2`` None: ``a b``): each operand's
    32-deep stages of the reduction in fresh accumulators, each m16n8k16
    step (16 exact products) added with a truncating addition, the stage
    added to that operand's total in f32 round-to-nearest; the two totals
    added at the end."""
    b64 = b.astype(np.float64)
    total = None
    for op in [a] + ([] if a2 is None else [a2]):
        op = op.astype(np.float64)
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for s0 in range(0, a.shape[1], 32):
            st = np.zeros_like(acc)
            for k0 in range(s0, min(s0 + 32, a.shape[1]), 16):
                st = _rz(st.astype(np.float64) + op[:, k0:k0 + 16] @ b64[k0:k0 + 16])
            acc = acc + st
        total = acc if total is None else total + acc
    return total


def _route_inputs(lists, q_rows, s_rows, x, kernel_points, extent):
    """(valid [Nq, L], gathered bf16 rows [Nq, L, C], bf16 weights [Nq, KP, L])
    of the lists, as float64 numpy."""
    valid = lists.lpos >= 0
    pos = lists.lpos.clamp(min=0).long()
    ld2 = None if lists.ld2 is None else lists.ld2[:, None, :]
    rows, q = s_rows[pos], q_rows[:, None, :]
    w = torch.cat([_bf16(_entry_weights(lists, ld2, valid[:, None, :], rows, q,
                                        kernel_points[k], extent))
                   for k in range(kernel_points.shape[0])], 1)
    xg = _bf16(x)[pos] * valid[..., None]
    return valid.numpy(), xg.double().numpy(), w.double().numpy()


def weighted_bf16_route(lists, q_rows, s_rows, x, kernel_points, extent, chunk, starts, tile):
    """(hi, lo) [Nq, KP * Cin] of ``weighted_bf16_kernel``: the pieces from
    the ballot; per piece, its k-steps of 16 entries from the piece's first
    entry (the weights masked to the piece's entries) added into fresh
    accumulators with truncating additions, the piece's sum rounded to bf16
    and added in f32; ``hi = bf16(S)``, ``lo = bf16(S - hi)``."""
    nq, kpn = q_rows.shape[0], kernel_points.shape[0]
    valid, xg, w = _route_inputs(lists, q_rows, s_rows, x, kernel_points, extent)
    lcnt = lists.lcnt.numpy()
    ws = starts.long().repeat_interleave(tile).numpy()
    first = piece_starts_ballot(lists.lpos.numpy(), lcnt, ws, chunk)
    total = np.zeros((nq, kpn, x.shape[1]), np.float32)
    for qi in range(nq):
        for j0, j1 in pieces_of(first[qi], int(lcnt[qi])):
            acc = np.zeros((kpn, x.shape[1]), np.float32)
            for k0 in range(j0, j1, 16):
                k1 = min(k0 + 16, j1)
                acc = _rz(acc.astype(np.float64) + w[qi][:, k0:k1] @ xg[qi, k0:k1])
            total[qi] = total[qi] + bf16_rn(acc)
    hi = bf16_rn(total)
    return hi.reshape(nq, -1), bf16_rn(total - hi).reshape(nq, -1)


def dx_by_pairs(lists, q_rows, s_rows, weights, kernel_points, gs, extent):
    """K4's bf16 dx as ``band_conv_bwd.cu`` computes it: V = bf16(gs W^T)
    (the product staged, rounded in its epilogue), U for each listed pair
    (query q, entry j, row r) = one m16n8k16 step from zero of its bf16
    weights by V[q] (a truncating addition of 15 exact products), then each
    support row's U summed in ascending pair order in f32."""
    kpn, c, cout = weights.shape
    nq, ns = q_rows.shape[0], s_rows.shape[0]
    wb = _bf16(weights).reshape(kpn * c, cout).numpy()
    v = bf16_rn(mma_bf16_two_staged(_bf16(gs).numpy(), None, wb.T)).reshape(nq, kpn, c)
    _, _, w = _route_inputs(lists, q_rows, s_rows, torch.zeros((ns, 1)), kernel_points, extent)
    u = _rz(np.einsum("qkl,qkc->qlc", w, v.astype(np.float64))).reshape(nq * lists.width, c)
    row_ptr, pairs = (t.numpy() for t in lists.transpose(ns))
    dx = np.zeros((ns, c), np.float32)
    for r in range(ns):
        for p in range(row_ptr[r], row_ptr[r + 1]):
            dx[r] = dx[r] + u[pairs[p]]
    return dx


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
