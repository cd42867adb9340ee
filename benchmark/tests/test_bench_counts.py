"""The kernels' and the model's counts of operations and bytes on a
hand-checked tiny pyramid."""

from harness.manifest import load_module
from reference import model as ref

LAUNCH = {"kp": 2, "cin": 1, "cout": 1, "q": 1, "s": 2, "pairs": 2, "dx": True}


def test_band_conv_by_hand():
    # 2 pairs x 2 kernel points x (12 + 2) + 2 pairs x 1 + 1 query x (2 x 2 + 1)
    # bytes: 4 x (2 x 4 supports + 3 query + 2 pairs + 2 weights + 6 kernel points + 1 out)
    assert load_module("counts", "band_conv").work(LAUNCH) == (63, 88)


def test_band_conv_bwd_by_hand():
    work = load_module("counts", "band_conv_bwd").work
    # dW 4; bytes 4 x (1 + 2 + 2 + 2)
    assert work(dict(LAUNCH, dx=False)) == (4, 28)
    # + dX 4 + 2 x 2 x (12 + 2); bytes + 4 x (3 + 6 + 2 + 6 + 2)
    assert work(LAUNCH) == (4 + 4 + 56, 28 + 76)


def _cfg():
    return {"first_subsampling_dl": 0.03, "conv_radius": 2.5, "in_features_dim": 1,
            "first_features_dim": 8, "deform_radius": 5.0}


def test_kpfcnn_forward_counts_one_more_pair():
    blocks = ref.blocks(_cfg(), ref.architecture(2))[:2]
    count = load_module("counts", "kpfcnn").forward_ops
    base = {"rows": [5, 2], "conv": [9, 3], "pool": [4]}
    more = dict(base, conv=[10, 3])
    # level 0 holds the simple block (1 input channel) and one resnetb
    # (8 // 4 = 2 channels): one pair more costs 15 (12 + 2 Cin) + Cin in each
    kp = 15
    want = kp * (12 + 2 * 1) + 1 + kp * (12 + 2 * 2) + 2
    assert count(blocks, more, kp, 4) - count(blocks, base, kp, 4) == want
    assert count(blocks, {"rows": [0, 0], "conv": [0, 0], "pool": [0]}, kp, 4) == 0
