"""Port vs JAX: ``utils/metrics.py`` bit for bit on seeded logits and
labels (absent classes, stacked [..., C, C] confusions; torch tensors
scored as their numpy copies), and ``utils/profiling.py``: ``trace``
writes a Chrome trace that holds an ``annotate`` region, ``SectionTimer``
reports in JAX's text for the same totals."""

import json
import os

import numpy as np
import pytest
import torch

from d3feat_tpu.utils import metrics as j_metrics
from d3feat_tpu.utils.profiling import SectionTimer as JSectionTimer
from d3feat_tpu_torch.utils import metrics
from d3feat_tpu_torch.utils.profiling import TRACE_FILE, SectionTimer, annotate, trace
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
    x = torch.randn(64, 64)
    with trace(str(tmp_path)) as prof:
        with annotate("port_region_under_test"):
            y = x @ x
    assert prof is not None and y.shape == (64, 64)
    path = os.path.join(str(tmp_path), TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_region_under_test" for e in events)


def test_section_timer_report_matches_jax():
    got, want = SectionTimer(), JSectionTimer()
    for t in (got, want):
        for name, total, count in (("pyramid", 0.0123456, 3), ("model", 0.5, 1),
                                   ("head", 0.00042, 7)):
            t.totals[name] = total
            t.counts[name] = count
    assert got.report() == want.report()
    assert got.report().splitlines()[0] == "model: 500.0 ms total, 500.00 ms/call x1"
    # sections accumulate; ``sync`` takes tensors nested in containers, and a
    # list filled inside the block
    st, out = SectionTimer(), []
    for _ in range(2):
        with st.section("matmul", sync=out):
            out.append({"y": (torch.ones(3) * 2,)})
    assert st.counts["matmul"] == 2 and st.totals["matmul"] > 0.0
