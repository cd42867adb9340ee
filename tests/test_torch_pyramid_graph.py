"""The band-route pyramid as a CUDA graph (``ops/pyramid.py``), on the card.

On the card checks' configuration (``data.pack.bench_config``) and two
pairs of eval-cache fragments of 12k-16k points: replayed pyramids equal
the eager build bit for bit, a returned pyramid is the caller's (a later
replay leaves it as it was), one capture serves every call of a spec,
K1's launch counter counts the graph's launches, the cache keeps the most
recently used graphs, and neither the eager build nor a replay waits on
the device (``torch.cuda.set_sync_debug_mode("error")``).

Skipped without a card. On the card, from the root of a checkout (the
suite's ``conftest.py`` imports JAX, which the port's machines need not
have)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pyramid_graph.py
"""

import contextlib
import dataclasses

import pytest
import torch

from d3feat_tpu_torch.ops import neighbors, pyramid
from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec
from d3feat_tpu_torch.ops.select import band_select
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def inputs(card):
    """(the bench spec, [(points, lengths)] of two fragment pairs on the card)."""
    from d3feat_tpu_torch.data.pack import bench_config, load_eval_fragments, pack_fragments

    cfg = bench_config()
    frags = load_eval_fragments(12000, 16000)[:4]
    out = []
    for i in (0, 2):
        b = pack_fragments(frags[i:i + 2], point_capacity=cfg.caps.points[0], num_clouds=2)
        out.append((torch.from_numpy(b["points"]).to(card),
                    torch.from_numpy(b["lengths"]).to(card)))
    return make_pyramid_spec(cfg, num_clouds=2), out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    return [t for v in items for t in _tensors(v)]


def _equal(a, b):
    """Same structure, every tensor equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@contextlib.contextmanager
def _no_syncs():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_replays_equal_the_eager_build_and_stay_the_callers(inputs):
    spec, ((p1, l1), (p2, l2)) = inputs
    pyramid._graphs.clear()
    counts = (build_pyramid.launches_captured, build_pyramid.launches_replayed)
    got1 = build_pyramid(p1, l1, spec=spec)
    kept1 = pyramid._clone(got1)
    k1 = band_select.launches
    got2 = build_pyramid(p2, l2, spec=spec)
    torch.cuda.synchronize()
    assert band_select.launches - k1 == 3 * spec.num_levels - 2  # K1 once a search
    assert (build_pyramid.launches_captured - counts[0],
            build_pyramid.launches_replayed - counts[1]) == (1, 2)
    assert _equal(got1, kept1)  # call 2's replay left call 1's pyramid as it was
    graph_out = {t.data_ptr() for t in _tensors(pyramid._graphs[next(iter(pyramid._graphs))].out)}
    assert not graph_out & {t.data_ptr() for t in _tensors(got1) + _tensors(got2)}
    assert not _equal(got1["points"], got2["points"])
    assert _equal(got1, pyramid._build_pyramid(p1, l1, spec, "auto"))
    assert _equal(got2, pyramid._build_pyramid(p2, l2, spec, "auto"))
    assert not bool(got1["overflow"]) and not bool(got2["overflow"])


def test_the_eager_build_and_a_replay_wait_on_the_device_nowhere(inputs):
    spec, ((p1, l1), _) = inputs
    pyramid._build_pyramid(p1, l1, spec, "auto")  # the kernels' libraries loaded
    pyramid._graphs.clear()
    neighbors._FRAME_DIRS_ON.clear()  # made again, by fills, inside the checked build
    with _no_syncs():
        eager = pyramid._build_pyramid(p1, l1, spec, "auto")
    build_pyramid(p1, l1, spec=spec)  # captured (the capture itself synchronises)
    with _no_syncs():
        replayed = build_pyramid(p1, l1, spec=spec)
    assert _equal(replayed, eager)


def test_the_cache_keeps_the_most_recently_used_graphs(inputs):
    """Nine specs, one more than the cache holds: the first is dropped and
    captured again on its next call; the others replay."""
    spec, ((p1, l1), _) = inputs
    pyramid._graphs.clear()
    specs = [dataclasses.replace(spec, band_frac=0.1 + 0.01 * i)
             for i in range(pyramid.GRAPHS + 1)]
    captured = build_pyramid.launches_captured
    for s in specs:
        build_pyramid(p1, l1, spec=s)
    assert len(pyramid._graphs) == pyramid.GRAPHS
    assert build_pyramid.launches_captured - captured == pyramid.GRAPHS + 1
    build_pyramid(p1, l1, spec=specs[-1])
    assert build_pyramid.launches_captured - captured == pyramid.GRAPHS + 1
    build_pyramid(p1, l1, spec=specs[0])
    assert build_pyramid.launches_captured - captured == pyramid.GRAPHS + 2
    pyramid._graphs.clear()
