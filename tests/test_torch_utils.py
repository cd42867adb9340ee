"""Port vs JAX: ``utils/metrics.py`` bit for bit on seeded logits and
labels (absent classes, stacked [..., C, C] confusions; torch tensors
scored as their numpy copies), and ``utils/profiling.py``: ``trace``
writes a Chrome trace that holds the port's spans."""

import json
import os

import numpy as np
import pytest
import torch

from d3feat_tpu.utils import metrics as j_metrics
from d3feat_tpu_torch.utils import metrics
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.utils.profiling import TRACE_FILE, trace
from tests.torch_port_helpers import jax_config, packed_pair, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

C = 7


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(300, C)).astype(np.float32)
    labels = rng.integers(0, C - 2, 300)  # the last two classes never true
    logits[:, C - 1] -= 10.0              # and the last never predicted: absent
    pred = logits.argmax(-1)
    for got, want in (
            (metrics.accuracy(logits, labels), j_metrics.accuracy(logits, labels)),
            (metrics.confusion_matrix(pred, labels, C),
             j_metrics.confusion_matrix(pred, labels, C)),
            (metrics.iou(pred, labels, C), j_metrics.iou(pred, labels, C))):
        _same(got, want)
    assert metrics.iou(pred, labels, C)[C - 1] == np.mean(metrics.iou(pred, labels, C)[:C - 1])
    stacked = rng.integers(0, 20, (2, 3, C, C))
    stacked[0, 1, 2, :] = stacked[0, 1, :, 2] = 0
    _same(metrics.iou_from_confusion(stacked), j_metrics.iou_from_confusion(stacked))
    # torch tensors are scored as their host copies
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    assert metrics.accuracy(tl, tb) == metrics.accuracy(logits, labels)
    _same(metrics.iou(tl.argmax(-1), tb, C), metrics.iou(pred, labels, C))
    _same(metrics.iou_from_confusion(torch.from_numpy(stacked)),
          metrics.iou_from_confusion(stacked))


def test_trace_holds_the_annotated_region(tmp_path):
    pts, _, lens = packed_pair(seed=3)
    spec = make_pyramid_spec(torch_config(jax_config(3)))
    with trace(str(tmp_path)) as prof:
        pyr = build_pyramid(torch.from_numpy(pts), torch.from_numpy(lens), spec=spec)
    assert prof is not None and len(pyr["points"]) == 3
    path = os.path.join(str(tmp_path), TRACE_FILE)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"port.pyramid", "port.pyramid.frame", "port.pyramid.level[0]",
            "port.pyramid.search[conv0]", "port.pyramid.subsample[1]",
            "port.sync.window_width"} <= names
