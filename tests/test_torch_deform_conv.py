"""K6, the deformable KPConv's neighbour sums (``ops/deform_conv.py``), and
the deformable model on the serving path.

On the CPU, at the 220-point pair of ``tests/torch_port_helpers.py`` (the
port's own synthetic pair and pyramid, 3 layers, width 16):

(a) the twin ``deform_sums_plain`` equals, bit for bit, the gather code
    that ``models/kpconv.py`` ran before it (copied here as
    ``_gather_kpconv`` and ``_gather_deformable``): shared kernel points
    (the offset KPConv, the rigid gather KPConv) and per-query moved ones
    with out-of-range neighbours dropped, on the conv0 and the pool0 lists;
    ``kpconv`` and ``deformable_kpconv`` equal their earlier outputs bit for
    bit, f32 and bf16, unmodulated and modulated;
(b) the extractor keeps the configuration's class: ``FeatureExtractor`` on
    a deformable subclass equals ``make_extract_step`` on the same
    configuration and bucket pyramid bit for bit, where the configuration
    rebuilt from ``to_dict()`` builds the rigid pyramid and answers
    otherwise; a rigid configuration's extraction equals the rebuilt
    configuration's bit for bit;
(c) one eager deformable forward under ``torch.profiler``: the spans
    ``deform.offsets``, ``deform.sums`` and ``deform.contract`` once a
    deformable block, each inside its block's ``model.block``, and the
    counters: two gather-route sums a deformable conv, no K6 launch;
(d) which calls ``uses_kernel`` sends to K6.

On the card (marker ``cuda``, skipped without one; from the root of a
checkout: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_deform_conv.py``): K6 against the twin at the deformable
configuration's widths (128-512 channels, 113-145 neighbours, 15 kernel
points), shared and per-query kernel points, dropping and not, and a
deformable extraction with K6 against the twins' (``impl="plain"``)."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.data.pack import pack_fragments
from d3feat_tpu_torch.data.synthetic import synthetic_pair
from d3feat_tpu_torch.eval.extract import FeatureExtractor
from d3feat_tpu_torch.models.kpconv import (SHADOW_COORD, KPConv, deformable_kpconv,
                                            gather_rows, influence, kpconv)
from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn
from d3feat_tpu_torch.ops.deform_conv import deform_sums, deform_sums_plain, uses_kernel
from d3feat_tpu_torch.ops.neighbors import permute_rows
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.train.step import make_extract_step
from tests.torch_port_helpers import CAPS, N_POINTS
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3
ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb",
        "resnetb_deformable_strided", "resnetb_deformable", "resnetb_deformable",
        "nearest_upsample", "unary", "nearest_upsample", "last_unary"]
UNIT_KP = "d3feat_tpu_torch/models/dispositions/k_015_center_3D.npy"


class DeformConfig(D3FeatConfig):
    def architecture(self):
        return list(ARCH)


def _config(cls=D3FeatConfig):
    cfg = cls(experiment_id="port-test")
    cfg.num_layers = LAYERS
    cfg.first_features_dim = 16
    cfg.first_subsampling_dl = 0.1
    # the deformable radius doubles level 2's searches: 40 neighbours hold them
    cfg.caps = PyramidCaps(points=CAPS[:LAYERS], neighbors=(40,) * LAYERS, corr=8)
    cfg.query_tile = 128
    return cfg


@pytest.fixture(scope="module")
def frags():
    rng = np.random.default_rng(3)
    p0, p1, _, _ = synthetic_pair(rng, n_points=N_POINTS, num_corr=8, extent=2.0)
    return [p0, p1]


@pytest.fixture(scope="module")
def pyramid(frags):
    b = pack_fragments(frags, point_capacity=CAPS[0], num_clouds=2)
    pyr = build_pyramid(torch.from_numpy(b["points"]), torch.from_numpy(b["lengths"]),
                        spec=make_pyramid_spec(_config(DeformConfig)))
    assert not bool(pyr["overflow"])
    return pyr


# --- (a) the twin against the gather code it replaced ----------------------


def _gather_kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, extent, mode, aggregation, cd):
    """``models/kpconv.py::kpconv``'s neighbour sums before K6: (weighted,
    the gathered rows its density read)."""
    kp = kernel_points.detach().float()
    s_ext = torch.cat([s_pts.detach().float(), s_pts.new_full((1, 3), SHADOW_COORD)])
    nb = s_ext[neighb_inds.long()] - q_pts.detach().float()[:, None, :]
    n_sq = (nb * nb).sum(-1)
    kp_sq = (kp * kp).sum(-1)
    cross = (nb[..., 0:1] * kp[:, 0] + nb[..., 1:2] * kp[:, 1]) + nb[..., 2:3] * kp[:, 2]
    sq_d = torch.clamp(n_sq[..., None] - 2.0 * cross + kp_sq, min=0.0)
    w = influence(sq_d, extent, mode)
    if aggregation == "closest":
        w = w * F.one_hot(sq_d.argmin(-1), kp.shape[0]).to(w.dtype)
    w = w.transpose(1, 2)
    neighb_x = gather_rows(x.to(cd), neighb_inds)
    return torch.bmm(w.to(cd).float(), neighb_x.float()), neighb_x


def _contract(weighted, weights, neighb_x, cd):
    kf, cin, cout = weights.shape
    w2 = weights.reshape(kf * cin, cout)
    if cd == torch.float32:
        out = weighted.reshape(-1, kf * cin) @ w2
    else:
        out = (weighted.reshape(-1, kf * cin).to(cd) @ w2.to(cd)).float()
    active = neighb_x.float().sum(-1) > 0.0
    return out / torch.clamp(active.sum(-1), min=1).to(out.dtype)[:, None]


def _gather_deformable(q_pts, s_pts, neighb_inds, x, conv, extent, mode, aggregation, cd):
    """``models/kpconv.py::deformable_kpconv`` before K6: (out, min_d2,
    deformed_kp, the deformed sums, the gathered rows of their density)."""
    w_off, nx_off = _gather_kpconv(q_pts, s_pts, neighb_inds, x, conv.offset_kernel_points,
                                   extent, mode, aggregation, cd)
    off = _contract(w_off, conv.offset_weights, nx_off, cd) + conv.offset_bias
    kp = conv.kernel_points.detach().float()
    k, p_dim = kp.shape
    if conv.modulated:
        unscaled = off[:, :p_dim * k].reshape(-1, k, p_dim)
        modulations = 2.0 * torch.sigmoid(off[:, p_dim * k:])
    else:
        unscaled, modulations = off.reshape(-1, k, p_dim), None
    deformed_kp = unscaled * extent + kp
    inds = neighb_inds.long()
    s_ext = torch.cat([s_pts.detach().float(), s_pts.new_full((1, p_dim), SHADOW_COORD)])
    nb = s_ext[inds] - q_pts.detach().float()[:, None, :]
    diff = nb[:, :, None, :] - deformed_kp[:, None, :, :]
    sq_d = (diff * diff).sum(-1)
    min_d2 = sq_d.amin(1)
    in_range = (sq_d < extent**2).any(-1)
    eff_inds = torch.where(in_range, inds, s_pts.shape[0])
    w = torch.where(in_range[:, :, None], influence(sq_d, extent, mode), 0.0)
    if aggregation == "closest":
        w = w * F.one_hot(sq_d.argmin(-1), k).to(w.dtype)
    w = w.transpose(1, 2)
    neighb_x = gather_rows(x, eff_inds)
    weighted = torch.bmm(w.to(cd).float(), neighb_x.to(cd).float())
    summed = weighted
    if modulations is not None:
        weighted = weighted * modulations[:, :, None]
    out = _contract(weighted, conv.weights, neighb_x, cd)
    return out, min_d2, deformed_kp, summed, neighb_x


def _case(pyramid, strided, modulated, seed=1):
    """(q, s, inds, x, KPConv with non-zero offsets, extent) on the conv0 or
    the pool0 lists of the deformable pyramid."""
    rng = np.random.default_rng(seed)
    q = pyramid["points"][1 if strided else 0]
    s = pyramid["points"][0]
    inds = pyramid["pools"][0] if strided else pyramid["neighbors"][0]
    n_valid = int(pyramid["lengths"][0].sum())
    cin, cout, r = 8, 12, 0.25
    x = torch.zeros((s.shape[0], cin))
    x[:n_valid] = torch.from_numpy(np.maximum(rng.normal(size=(n_valid, cin)), -0.1)
                                   .astype(np.float32))
    conv = KPConv(np.load(UNIT_KP) * r, cin, cout, torch.Generator().manual_seed(seed),
                  deformable=True, modulated=modulated)
    with torch.no_grad():
        conv.offset_bias.copy_(torch.from_numpy(
            0.3 * rng.normal(size=conv.offset_bias.shape).astype(np.float32)))
    return q, s, inds, x, conv, r * 1.2 / 2.5


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _density(neighb_x):
    return torch.clamp((neighb_x.float().sum(-1) > 0.0).sum(-1), min=1).float()


CDS = {"f32": torch.float32, "bf16": torch.bfloat16}
MODES = [("linear", "sum"), ("gaussian", "closest")]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("mode", MODES)
def test_twin_shared_kernel_points_equals_the_gather_kpconv(pyramid, strided, cd, mode):
    q, s, inds, x, conv, ext = _case(pyramid, strided, False)
    cd = CDS[cd]
    weighted, density, min_d2 = deform_sums_plain(
        q, s, inds, x, conv.kernel_points, extent=ext, drop=False, influence=mode[0],
        aggregation=mode[1], compute_dtype=cd)
    want, neighb_x = _gather_kpconv(q, s, inds, x, conv.kernel_points, ext, *mode, cd)
    assert min_d2 is None and float(want.abs().max()) > 1e-2
    _equal(weighted, want)
    _equal(density, _density(neighb_x))
    kw = dict(KP_extent=ext, KP_influence=mode[0], aggregation_mode=mode[1], compute_dtype=cd)
    _equal(kpconv(q, s, inds, x, conv.weights, conv.kernel_points, **kw),
           _contract(want, conv.weights, neighb_x, cd))


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("cd", list(CDS))
@pytest.mark.parametrize("mode", MODES)
def test_deformable_kpconv_equals_the_gather_code(pyramid, strided, modulated, cd, mode):
    q, s, inds, x, conv, ext = _case(pyramid, strided, modulated, seed=2 + strided)
    cd = CDS[cd]
    out, min_d2, deformed_kp, summed, neighb_x = _gather_deformable(q, s, inds, x, conv, ext,
                                                                    *mode, cd)
    dropped = int((neighb_x.abs().sum(-1) == 0).sum() - (inds == s.shape[0]).sum())
    assert dropped > 0  # some listed neighbour is in range of no moved point
    weighted, density, got_min = deform_sums_plain(
        q, s, inds, x, deformed_kp, extent=ext, drop=True, influence=mode[0],
        aggregation=mode[1], compute_dtype=cd)
    _equal(weighted, summed)
    _equal(density, _density(neighb_x))
    _equal(got_min, min_d2)
    got, aux = deformable_kpconv(q, s, inds, x, conv, KP_extent=ext, KP_influence=mode[0],
                                 aggregation_mode=mode[1], compute_dtype=cd)
    _equal(got, out)
    _equal(aux.min_d2, min_d2)
    _equal(aux.deformed_kp, deformed_kp)


def test_twin_keeps_the_gradients(pyramid):
    q, s, inds, x, conv, ext = _case(pyramid, False, False)
    x = x.clone().requires_grad_(True)
    out, aux = deformable_kpconv(q, s, inds, x, conv, KP_extent=ext)
    (out.sum() + aux.min_d2.sum()).backward()
    for t in (x, conv.weights, conv.offset_weights, conv.offset_bias):
        assert t.grad is not None and float(t.grad.abs().max()) > 0
    assert conv.kernel_points.grad is None and conv.offset_kernel_points.grad is None


# --- (b) the extractor keeps the configuration's class ---------------------


def _step_outputs(cfg, model, frags, impl="auto"):
    b = pack_fragments(frags, point_capacity=CAPS[0], num_clouds=2)
    feats, scores, overflow = make_extract_step(cfg, num_clouds=2, impl=impl)(
        model, {k: torch.from_numpy(v) for k, v in b.items()})
    assert not bool(overflow)
    out, row = [], 0
    for f in frags:
        out.append((feats[row:row + len(f)].numpy(), scores[row:row + len(f), 0].numpy()))
        row += len(f)
    return out


def _extracted(cfg, model, frags):
    ex = FeatureExtractor(cfg, model, buckets=(CAPS[0] // 2,), batch_fragments=2,
                          on_overflow="raise", device="cpu")
    return ex.extract_many(frags)


def _same(a, b):
    return all(np.array_equal(fa, fb) and np.array_equal(sa, sb)
               for (fa, sa), (fb, sb) in zip(a, b))


def test_extractor_serves_the_deformable_architecture(frags):
    cfg = _config(DeformConfig)
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    got = _extracted(cfg, model, frags)
    assert _same(got, _step_outputs(cfg, model, frags))
    rebuilt = D3FeatConfig.from_dict(cfg.to_dict())
    assert rebuilt.architecture() != ARCH
    # the rebuilt configuration searches level 2 at the rigid radius
    assert not _same(got, _step_outputs(rebuilt, model, frags))


def test_extractor_rigid_configuration_unchanged(frags):
    cfg = _config()
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    rebuilt = D3FeatConfig.from_dict(cfg.to_dict())
    assert dataclasses.replace(cfg) == rebuilt
    assert _same(_extracted(cfg, model, frags), _step_outputs(rebuilt, model, frags))


# --- (c) spans and counters ------------------------------------------------


def _base(name):
    return name.split("[", 1)[0][len("port."):]


def test_deformable_forward_spans_and_counters(pyramid, frags):
    cfg = _config(DeformConfig)
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    n_def = sum(1 for b in model.encoder if getattr(getattr(b, "conv", None), "deformable",
                                                   False))
    assert n_def == 3
    b = pack_fragments(frags, point_capacity=CAPS[0], num_clouds=2)
    order0 = pyramid["band"][0]["order"]
    batch = dict(pyramid, features=permute_rows(torch.from_numpy(b["features"]), order0))
    before = (deform_sums.launches, deform_sums.launches_fallback)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        apply_kpfcnn(model, batch, per_cloud_norm=True)
    assert (deform_sums.launches, deform_sums.launches_fallback) == (before[0],
                                                                      before[1] + 2 * n_def)
    rs = sorted([(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("port.")], key=lambda r: (r[1], -r[2]))
    counts = collections.Counter(_base(n) for n, *_ in rs)
    assert [counts[k] for k in ("deform.offsets", "deform.sums", "deform.contract")] == [n_def] * 3
    blocks = [r for r in rs if _base(r[0]) == "model.block"]
    deform_blocks = [r for r in blocks if "deformable" in r[0]]
    assert len(deform_blocks) == n_def
    for name, s, e in rs:
        if _base(name).startswith("deform."):
            inner = min((bl for bl in blocks if bl[1] <= s and e <= bl[2]),
                        key=lambda bl: bl[2] - bl[1])
            assert inner in deform_blocks, (name, inner)
    # each deformable block holds the three spans in order
    for _, s, e in deform_blocks:
        assert [_base(n) for n, s2, e2 in rs if s <= s2 and e2 <= e and
                _base(n).startswith("deform.")] == ["deform.offsets", "deform.sums",
                                                    "deform.contract"]


# --- (d) routing -----------------------------------------------------------


def test_uses_kernel_routes():
    x, kp = torch.zeros((4, 8)), torch.zeros((15, 3))
    args = ("linear", "sum", torch.float32)
    assert not uses_kernel("auto", x, kp, *args)  # a CPU tensor
    assert not uses_kernel("plain", x, kp, *args)
    assert uses_kernel("kernel", x, kp, *args)
    for bad in (("gaussian", "sum", torch.float32), ("linear", "closest", torch.float32),
                ("linear", "sum", torch.bfloat16)):
        with pytest.raises(ValueError):
            uses_kernel("kernel", x, kp, *bad)
    for shape in ((16, 3), (4, 16, 3)):  # the kernel weighs 15 kernel points
        with pytest.raises(ValueError):
            uses_kernel("kernel", x, torch.zeros(shape), *args)
    with pytest.raises(ValueError):  # and at most 512 channels
        uses_kernel("kernel", torch.zeros((4, 513)), kp, *args)
    with pytest.raises(ValueError):
        uses_kernel("kernel", x.requires_grad_(True), kp, *args)
    with torch.no_grad():
        assert uses_kernel("kernel", x, kp, *args)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        deform_sums(torch.zeros((4, 3)), torch.zeros((4, 3)), torch.zeros((4, 2), dtype=torch.int32),
                    torch.zeros((4, 8)), kp, extent=1.0, drop=False, impl="kernel")


# --- on the card -----------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _wide_case(card, cin, nn, nq=1536, ns=3072, seed=0):
    """Random clouds with lists of the ``nn`` nearest supports within a
    radius (the shadow past them), ``cin`` channels, 15 kernel points."""
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((ns, 3), generator=g) * 2.0
    q = s[torch.randperm(ns, generator=g)[:nq]] + 0.01 * torch.randn((nq, 3), generator=g)
    q[-64:] = SHADOW_COORD  # padding queries list only the shadow
    d2 = torch.cdist(q, s) ** 2
    radius = 0.3
    best, inds = torch.topk(d2, nn, largest=False)
    inds = torch.where(best < radius**2, inds, ns).to(torch.int32)
    x = torch.randn((ns, cin), generator=g)
    x[::7] = -x[::7].abs()  # rows that sum below 0 count in no density
    ext = radius / 2.0
    kp = torch.from_numpy(np.load(UNIT_KP)).float() * ext * 0.8
    moved = kp + 0.3 * ext * torch.randn((nq, 15, 3), generator=g)
    return [t.to(card) for t in (q, s, inds, x, kp, moved)] + [ext]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,nn", [(128, 145), (256, 135), (512, 113), (20, 40)])
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("drop", [False, True])
def test_k6_matches_the_twin_on_the_card(card, cin, nn, per_query, drop):
    q, s, inds, x, kp, moved, ext = _wide_case(card, cin, nn)
    kps = moved if per_query else kp
    before = deform_sums.launches
    got = deform_sums(q, s, inds, x, kps, extent=ext, drop=drop, impl="kernel")
    want = deform_sums_plain(q, s, inds, x, kps, extent=ext, drop=drop)
    torch.cuda.synchronize()
    assert deform_sums.launches == before + 1
    scale = float(want[0].abs().max())
    assert scale > 1.0
    # sums of up to 145 products in another order, and for shared kernel
    # points d2 by differences against the twin's expansion
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5 * scale)
    assert torch.equal(got[1], want[1])
    if per_query:
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=1e-7)
    else:
        assert got[2] is None and want[2] is None


@pytest.mark.cuda
def test_deformable_extraction_on_k6(card, frags):
    cfg = _config(DeformConfig)
    model = init_kpfcnn(cfg, seed=1, device=card)
    b = pack_fragments(frags, point_capacity=CAPS[0], num_clouds=2)
    batch = {k: torch.from_numpy(v).to(card) for k, v in b.items()}
    before = (deform_sums.launches, deform_sums.launches_fallback)
    feats, scores, _ = make_extract_step(cfg, num_clouds=2)(model, batch)
    torch.cuda.synchronize()
    assert (deform_sums.launches - before[0], deform_sums.launches_fallback - before[1]) == (6, 0)
    tf, ts, _ = make_extract_step(cfg, num_clouds=2, impl="plain")(model, batch)
    n = int(b["lengths"].sum())
    torch.testing.assert_close(feats[:n], tf[:n], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(scores[:n], ts[:n], rtol=1e-4, atol=1e-5)
