"""The port's spans and host-sync ranges (``utils/profiling.py``) on the CPU,
at the tests' 220-point shapes (3 layers): with no profiler every span is
the one shared no-op and no ``RecordFunction`` is entered; under
``torch.profiler`` a tiny extraction and a tiny train step record every
span of the port's table, nested as stated, with the sync sites at the
counts the code implies and the call's number on the top-level span; and
the outputs with the profiler on equal those with it off, bit for bit."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.data.pack import pack_pair
from d3feat_tpu_torch.data.synthetic import synthetic_pair
from d3feat_tpu_torch.eval.extract import FeatureExtractor
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.train.optim import make_optimizer
from d3feat_tpu_torch.train.step import TrainState, make_eval_step, make_train_step
from d3feat_tpu_torch.utils import profiling
from tests.torch_port_helpers import CAPS, N_POINTS, NEIGHBORS
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3


def _config():
    cfg = D3FeatConfig(experiment_id="port-test")
    cfg.num_layers = LAYERS
    cfg.first_features_dim = 16
    cfg.first_subsampling_dl = 0.1
    cfg.caps = PyramidCaps(points=CAPS[:LAYERS], neighbors=(NEIGHBORS,) * LAYERS, corr=8)
    cfg.query_tile = 128
    return cfg


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(3)
    p0, p1, corr, dk = synthetic_pair(rng, n_points=N_POINTS, num_corr=8, extent=2.0)
    ones = np.ones((N_POINTS, 1), np.float32)
    packed = pack_pair(p0, p1, ones, ones, corr, dk, point_capacity=CAPS[0], corr_capacity=8)
    return [p0, p1], {k: torch.from_numpy(np.asarray(getattr(packed, k)))
                      for k in packed._fields}


def _extractor():
    cfg = _config()
    return FeatureExtractor(cfg, init_kpfcnn(cfg, seed=1, device="cpu"), buckets=(256,),
                            batch_fragments=2, device="cpu")


def _trainer():
    cfg = _config()
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    return TrainState(model, make_optimizer(cfg, model)), make_train_step(cfg)


def _ranges(fn):
    """(fn's result, [(name, start, end, thread)] of the port's ranges,
    by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    rs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
          for e in prof.profiler.kineto_results.events() if e.name().startswith("port.")]
    return out, sorted(rs, key=lambda r: (r[1], -r[2]))


def _base(name):
    return name.split("[", 1)[0][len("port."):]


def _parents(rs):
    """{index: the innermost range enclosing range ``index`` on its thread}."""
    out = {}
    for i, (_, s, e, tid) in enumerate(rs):
        best = None
        for j, (_, s2, e2, tid2) in enumerate(rs):
            if j != i and tid2 == tid and s2 <= s and e <= e2 and (s2, -e2) < (s, -e) and (
                    best is None or e2 - s2 < rs[best][2] - rs[best][1]):
                best = j
        out[i] = best
    return out


def _counts(rs):
    return collections.Counter(_base(n) for n, *_ in rs)


def _check_parents(rs, allowed):
    """Every range's innermost enclosing range is one of ``allowed[name]``
    (None: a top-level range)."""
    parents = _parents(rs)
    for i, (name, *_) in enumerate(rs):
        p = parents[i]
        got = None if p is None else _base(rs[p][0])
        assert got in allowed[_base(name)], (name, got)


PYRAMID_PARENTS = {
    "pyramid.frame": {"pyramid"}, "pyramid.level": {"pyramid"}, "pyramid.search": {"pyramid"},
    "pyramid.subsample": {"pyramid"},
    # the twins of K1 (every search) and of K2/K3 (every block and the head)
    "sync.window_width": {"pyramid.search", "model.block", "model.head", "train.backward"},
}


def _pyramid_counts():
    """The pyramid's ranges as ``ops/pyramid.py`` builds it on the band
    route: L levels, L conv searches, L - 1 pool, upsample and subsample
    calls; its one sync site is the K1 twin's window width, once a
    search (the kernel sizes its windows on the host and syncs nowhere)."""
    L = LAYERS
    searches = L + 2 * (L - 1)
    return {"pyramid": 1, "pyramid.frame": 1, "pyramid.level": L, "pyramid.search": searches,
            "pyramid.subsample": L - 1, "sync.window_width": searches}


def test_span_off_is_the_shared_noop(pair, monkeypatch):
    def entered(*a, **kw):
        raise AssertionError("a RecordFunction entered with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", entered)
    assert profiling.span("a") is profiling.span("b", 3) is profiling.span("c", ("d", 1))
    frags, batch = pair
    assert len(_extractor().extract_many(frags)) == 2
    state, step = _trainer()
    _, m = step(state, batch, 0)
    assert m.skipped == 0.0 and state.step == 1
    assert profiling.device_tensor(2.5, "cpu", site="x").item() == 2.5


def test_extraction_records_its_spans(pair):
    frags, _ = pair
    ex = _extractor()
    ex.extract_many(frags)  # call 0, unprofiled
    _, rs = _ranges(lambda: ex.extract_many(frags))
    names = [n for n, *_ in rs]
    assert names[0] == "port.extract[1]" and names.count("port.extract[1]") == 1
    assert not any(n.startswith("port.extract[") for n in names[1:])
    got = _counts(rs)
    want = _pyramid_counts()
    want.update({"extract": 1, "extract.pack": 1, "extract.step": 1, "extract.copy_out": 1,
                 "sync.copy_in": 3, "sync.overflow": 0, "sync.copy_out": 1,
                 "model.block": 12, "model.head": 1, "sync.const.head": 2,
                 "sync.window_width": 7 + 9})  # the K2 twin of each block and the head's
    for k, v in want.items():
        assert got[k] == v, (k, got[k], v)
    pyr = next(i for i, r in enumerate(rs) if r[0] == "port.pyramid")
    inside = [r for r in rs if rs[pyr][1] <= r[1] and r[2] <= rs[pyr][2]]
    assert [_base(n) for n, *_ in inside if _base(n).startswith("sync.")] == \
        ["sync.window_width"] * _pyramid_counts()["sync.window_width"]
    assert [n for n, *_ in rs if _base(n) == "pyramid.search"] == [
        "port.pyramid.search[conv0]", "port.pyramid.search[pool0]", "port.pyramid.search[up0]",
        "port.pyramid.search[conv1]", "port.pyramid.search[pool1]", "port.pyramid.search[up1]",
        "port.pyramid.search[conv2]"]
    assert [n for n, *_ in rs if _base(n) == "pyramid.level"] == [
        f"port.pyramid.level[{l}]" for l in range(LAYERS)]
    blocks = [n for n, *_ in rs if _base(n) == "model.block"]
    assert blocks[0] == "port.model.block[enc:0:simple]"
    assert blocks[-1] == "port.model.block[dec:3:last_unary]"
    _check_parents(rs, dict(PYRAMID_PARENTS, **{
        "extract": {None}, "extract.pack": {"extract"}, "extract.step": {"extract"},
        "extract.copy_out": {"extract"}, "sync.copy_in": {"extract.step"},
        "sync.copy_out": {"extract.copy_out"},
        "pyramid": {"extract.step"}, "model.block": {"extract.step"},
        "model.head": {"extract.step"}, "sync.const.head": {"model.head"}}))


def test_train_step_records_its_spans(pair):
    _, batch = pair
    state, step = _trainer()
    _, rs = _ranges(lambda: step(state, batch, 0))
    assert rs[0][0] == "port.train.step[0]"
    got = _counts(rs)
    for k in ("train.step", "train.forward", "train.backward", "train.finite",
              "train.optimizer", "sync.metrics", "pyramid", "model.head"):
        assert got[k] == 1, (k, got[k])
    assert got["train.allreduce"] == 0 and got["model.block"] == 12
    for k, v in _pyramid_counts().items():
        if k != "sync.window_width":
            assert got[k] == v, (k, got[k], v)
    assert [_base(n) for n, *_ in rs if _base(n).startswith("train.")] == [
        "train.step", "train.forward", "train.backward", "train.finite", "train.optimizer"]
    _check_parents(rs, dict(PYRAMID_PARENTS, **{
        "train.step": {None}, "train.forward": {"train.step"}, "train.backward": {"train.step"},
        "train.finite": {"train.step"}, "train.optimizer": {"train.step"},
        "sync.metrics": {"train.finite"}, "pyramid": {"train.forward"},
        "model.block": {"train.forward"}, "model.head": {"train.forward"}}))
    _, rs = _ranges(lambda: step(state, batch, 0))
    assert rs[0][0] == "port.train.step[1]"
    # the eval step's one copy of its metrics
    _, rs = _ranges(lambda: make_eval_step(_config())(state.model, batch))
    assert _counts(rs)["sync.metrics"] == 1


def test_pyramid_sync_counts(pair):
    """The pyramid alone, on the band route and on the original-order
    route's brute search (its steps sized on the host, three copies a
    search)."""
    _, batch = pair
    spec = make_pyramid_spec(_config())
    _, rs = _ranges(lambda: build_pyramid(batch["points"], batch["lengths"], spec=spec))
    assert dict(_counts(rs)) == _pyramid_counts()
    _check_parents(rs, dict(PYRAMID_PARENTS, pyramid={None}))
    cfg = _config()
    cfg.neighbor_search = "brute"
    spec = make_pyramid_spec(cfg)
    _, rs = _ranges(lambda: build_pyramid(batch["points"], batch["lengths"], spec=spec))
    got = _counts(rs)
    searches = LAYERS + 2 * (LAYERS - 1)
    assert got["pyramid.search"] == searches and got["pyramid.level"] == 0
    assert got["sync.row_groups"] == 3 * searches
    assert got["sync.candidates"] >= searches  # one a step of tiles, at least one a search


@pytest.mark.parametrize("path", ["extract", "train"])
def test_outputs_equal_with_the_profiler_on_and_off(pair, path):
    frags, batch = pair
    if path == "extract":
        outs = [_extractor().extract_many(frags),
                _ranges(lambda: _extractor().extract_many(frags))[0]]
        for (fa, sa), (fb, sb) in zip(*outs):
            assert np.array_equal(fa, fb) and np.array_equal(sa, sb)
        return
    got = []
    for on in (False, True):
        state, step = _trainer()
        run = lambda: [step(state, batch, 0)[1] for _ in range(2)]  # noqa: E731
        metrics = _ranges(run)[0] if on else run()
        got.append((metrics, {n: t.detach().clone() for n, t in state.model.state_dict().items()},
                    state.step))
    (m0, p0, s0), (m1, p1, s1) = got
    assert m0 == m1 and s0 == s1 == 2
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
