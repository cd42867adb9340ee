"""The reference against the port's plain twins at the small shapes of
``tests/test_band_head.py`` (a two-level model of width 16 on a synthetic
pair of 220 points a cloud, 14 neighbours, capacities 512 and 256), and
the reference's deformable KPConv and regulariser against the port's."""

import numpy as np
import pytest
import torch

from harness import program
from reference import model as ref

CFG = {"num_layers": 2, "first_features_dim": 16, "first_subsampling_dl": 0.1,
       "conv_radius": 2.5, "deform_radius": 5.0, "KP_extent": 2.0, "in_features_dim": 1,
       "output_dim": 32, "num_kernel_points": 15, "caps": {"points": [512, 256],
                                                           "neighbors": [14, 14], "corr": 8},
       "query_tile": 128, "num_node": 8, "safe_radius": 0.1, "log_scale": 10.0,
       "pos_margin": 0.1, "neg_margin": 1.4, "desc_loss_weight": 1.0, "det_loss_weight": 1.0}


@pytest.fixture(scope="module")
def setup():
    from d3feat_tpu_torch.data.pack import pack_pair
    from d3feat_tpu_torch.data.synthetic import synthetic_pair
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    cfg = program.make_config(CFG)
    rng = np.random.default_rng(3)
    pts0, pts1, corr, dk = synthetic_pair(rng, n_points=220, num_corr=8, extent=2.0)
    packed = pack_pair(pts0, pts1, np.ones((220, 1), np.float32), np.ones((220, 1), np.float32),
                       corr, dk, point_capacity=512, corr_capacity=8)
    batch = {k: torch.from_numpy(np.asarray(getattr(packed, k))) for k in packed._fields}
    pyr = build_pyramid(batch["points"], batch["lengths"], spec=make_pyramid_spec(cfg))
    assert not bool(pyr["overflow"])
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return cfg, batch, pyr, model, weights


def _ref_pyramid(pyr):
    return {k: pyr[k] for k in ("points", "neighbors", "pools", "upsamples", "masks", "lengths")}


def test_forward_matches_the_twins(setup):
    from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn
    from d3feat_tpu_torch.ops.neighbors import permute_rows

    cfg, batch, pyr, model, weights = setup
    order = pyr["band"][0]["order"]
    out = apply_kpfcnn(model, dict(pyr, features=permute_rows(batch["features"], order)),
                       impl="plain")
    arch = ref.architecture(2)
    desc, scores, margin, _ = ref.forward(weights, _ref_pyramid(pyr), CFG, arch, train=False,
                                          cloud_of_row=torch.zeros(512, dtype=torch.long))
    assert torch.allclose(desc, out.features, atol=2e-5)
    clear = margin.abs() >= 1e-4
    assert torch.allclose(scores[clear], out.scores[clear], atol=2e-5)


def test_train_gradients_match_the_twins(setup):
    from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn
    from d3feat_tpu_torch.ops.neighbors import permute_rows

    cfg, batch, pyr, model, weights = setup
    order = pyr["band"][0]["order"]
    model.zero_grad()
    out = apply_kpfcnn(model, dict(pyr, features=permute_rows(batch["features"], order)),
                       train=True, impl="plain")
    (out.features.sum() + out.scores.sum()).backward()
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    desc, scores, _, _ = ref.forward(p, _ref_pyramid(pyr), CFG, ref.architecture(2), train=True)
    (desc.sum() + scores.sum()).backward()
    for name, t in model.named_parameters():
        assert torch.allclose(p[name].grad, t.grad, atol=1e-4, rtol=1e-3), name


def test_deformable_kpconv_and_regulariser():
    from d3feat_tpu_torch.losses.regularizers import p2p_fitting_regularizer
    from d3feat_tpu_torch.models.kpconv import KPConv, deformable_kpconv

    gen = torch.Generator().manual_seed(0)
    s = torch.rand(300, 3, generator=gen)
    q = s[:120]
    d2 = ((q[:, None] - s[None]) ** 2).sum(-1)
    inds = torch.argsort(d2, 1)[:, :24]
    inds = torch.where(torch.gather(d2, 1, inds) < 0.04, inds, 300)
    x = torch.rand(300, 8, generator=gen)
    kp = torch.rand(15, 3, generator=gen) * 0.2 - 0.1
    conv = KPConv(kp.numpy(), 8, 16, gen, deformable=True)
    extent = 0.12
    got, aux = deformable_kpconv(q, s, inds, x, conv, KP_extent=extent)
    p = {f"c.{k}": v for k, v in conv.state_dict().items()}
    want, (min_d2, deformed, e) = ref.deformable_kpconv(q, s, inds, x, p, "c.", extent)
    assert torch.allclose(got, want, atol=1e-5)
    # KPConv's regulariser takes each conv's own extent
    assert torch.allclose(p2p_fitting_regularizer([aux], KP_extent=extent),
                          ref.fitting_regulariser([(min_d2, deformed, e)]), rtol=1e-4)
