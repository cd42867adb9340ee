"""The extractor's copy back through pinned memory (``ops/transfer.py``),
on the card.

On the bench configuration and 16 eval-cache fragments of 12k-16k points
served in groups of 8: one copy back a step is staged through pinned
memory, holding the step's valid rows alone; it gives the same arrays as a
plain copy of the same outputs, bit for bit; an array returned survives the
next group; and a group waits on the device 12 times (3 copies in, the
head's 8 constants, the one copy back), by the ``port.sync.*`` ranges and
by ``torch.cuda.set_sync_debug_mode("warn")`` alike.

Skipped without a card. On the card, from the root of a checkout (the
suite's ``conftest.py`` imports JAX, which the port's machines need not
have)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_copy_out.py
"""

import collections
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d3feat_tpu_torch.data.pack import choose_bucket, pack_fragments
from d3feat_tpu_torch.eval.extract import FeatureExtractor
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.ops.transfer import to_host
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.cuda

GROUP = 8


@pytest.fixture(scope="module")
def served():
    """(an extractor on the card serving groups of 8, two groups of
    fragments), its bucket's step built and its pyramid captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from d3feat_tpu_torch.bench import bench_config
    from d3feat_tpu_torch.data.pack import load_eval_fragments

    cfg = bench_config()
    ex = FeatureExtractor(cfg, init_kpfcnn(cfg, seed=1, device="cuda"),
                          batch_fragments=GROUP, device="cuda")
    frags = load_eval_fragments(12000, 16000)[: 2 * GROUP]
    groups = (frags[:GROUP], frags[GROUP:])
    ex.extract_many(groups[0])
    return ex, groups


def _base_tensor(a):
    """The tensor whose memory the numpy array ``a`` views."""
    while not isinstance(a, torch.Tensor):
        a = a.base
    return a


def test_one_pinned_copy_of_the_valid_rows_a_step(served):
    ex, (group, _) = served
    rows = sum(len(f) for f in group)
    launches = to_host.launches
    got = ex.extract_many(group)
    assert to_host.launches - launches == 1
    for d, s in got:
        assert d.dtype == s.dtype == np.float32 and d.flags.c_contiguous
        assert _base_tensor(d).is_pinned() and _base_tensor(d).shape == (rows, 32)
        assert _base_tensor(s).is_pinned() and _base_tensor(s).shape == (rows,)


def test_equal_to_a_plain_copy_of_the_same_outputs(served):
    ex, (group, _) = served
    rows = sum(len(f) for f in group)
    per_frag = choose_bucket(max(len(f) for f in group), ex.buckets)
    batch = pack_fragments(group, point_capacity=GROUP * per_frag, num_clouds=GROUP)
    feats, scores, ov = ex._step_for(GROUP * per_frag, GROUP)(
        ex.model, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    launches = to_host.launches
    d, s, overflowed = to_host(feats, scores, ov, rows)
    assert to_host.launches - launches == 1
    assert overflowed is bool(ov.cpu()) is False
    want_d, want_s = feats[:rows].cpu().numpy(), scores[:rows, 0].cpu().numpy()
    assert d.dtype == want_d.dtype and d.shape == want_d.shape and np.array_equal(d, want_d)
    assert s.dtype == want_s.dtype and s.shape == want_s.shape and np.array_equal(s, want_s)


def test_an_array_returned_survives_the_next_group(served):
    ex, (first, second) = served
    got = ex.extract_many(first)
    kept = [(d.copy(), s.copy()) for d, s in got]
    later = ex.extract_many(second)
    torch.cuda.synchronize()
    assert not np.shares_memory(got[0][0], later[0][0])
    for (d, s), (kd, ks) in zip(got, kept):
        assert np.array_equal(d, kd) and np.array_equal(s, ks)


def test_twelve_syncs_a_group(served):
    ex, (group, _) = served
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex.extract_many(group)
    ranges = collections.Counter(
        e.name().split("[")[0][len("port.sync."):]
        for e in prof.profiler.kineto_results.events() if e.name().startswith("port.sync."))
    assert ranges == {"copy_in": 3, "const.head": GROUP, "copy_out": 1}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ex.extract_many(group)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert sum("called a synchronizing" in str(w.message) for w in caught) == 12
