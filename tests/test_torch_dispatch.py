"""One rule decides kernel or twin (``ops/build.py::uses_kernel``):
``"auto"`` the kernel on a CUDA tensor and the twin elsewhere, ``"kernel"``
always, ``"plain"`` never; any other ``impl`` raises ``ValueError`` in
every dispatcher before it runs either."""

import types

import pytest
import torch

from d3feat_tpu_torch.ops import band_conv, band_lists, build, deform_conv, head, neighbors, select
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

CUDA = types.SimpleNamespace(is_cuda=True)  # stands in for a card's tensor


@pytest.mark.parametrize("on_card", [False, True])
@pytest.mark.parametrize("impl, kernel", [("auto", None), ("plain", False), ("kernel", True),
                                          ("twin", ValueError)])
def test_uses_kernel(impl, kernel, on_card):
    t = CUDA if on_card else torch.zeros(1)
    if kernel is ValueError:
        with pytest.raises(ValueError, match="impl must be"):
            build.uses_kernel(impl, t)
    else:
        assert build.uses_kernel(impl, t) is (on_card if kernel is None else kernel)


# every kernel and twin the dispatchers below can run
ROUTES = {select: ("select_kernel", "select_plain"),
          band_lists: ("band_lists_kernel", "band_lists_plain", "band_lists_given_kernel",
                       "band_lists_given_plain", "transpose_lists_kernel",
                       "transpose_lists_plain"),
          head: ("band_head_kernel", "band_head_plain", "band_head_bwd_kernel",
                 "band_head_bwd_plain"),
          band_conv: ("band_conv_kernel", "band_conv_plain", "band_conv_bwd_kernel",
                      "band_conv_bwd_plain"),
          deform_conv: ("deform_sums_kernel", "deform_sums_plain")}

NQ, NS, T, C = 32, 40, 32, 4
WIN = dict(starts=torch.zeros(1, dtype=torch.int32), wends=torch.full((1,), NS, dtype=torch.int32))


def _rows(n):
    return torch.cat([torch.rand(n, 3), torch.zeros(n, 1)], 1)


def _thr():
    return dict(q_rows=_rows(NQ), thr=torch.ones(NQ), ptie=torch.full((NQ,), NS), s_rows=_rows(NS))


def _conv():
    return dict(_thr(), x=torch.rand(NS, C), weights=torch.rand(15, C, C),
                kernel_points=torch.rand(15, 3), **WIN, query_tile=T, extent=1.0)


def _lists():
    return band_lists.BandLists(torch.zeros((NQ, 64), dtype=torch.int32), torch.zeros((NQ, 64)),
                                torch.zeros(NQ, dtype=torch.int32))


CALLS = {
    "band_select": lambda impl: select.band_select(
        _rows(NQ), _rows(NS), **WIN, query_tile=T, r2=0.1, max_k=8, impl=impl),
    "band_lists": lambda impl: band_lists.band_lists(**_thr(), **WIN, query_tile=T, impl=impl),
    "band_lists_given": lambda impl: band_lists.band_lists_given(
        torch.zeros((8, NQ), dtype=torch.int32), **WIN, query_tile=T, n_rows=NS, impl=impl),
    "transpose_lists": lambda impl: band_lists.transpose_lists(_lists(), NS, impl=impl),
    "band_head": lambda impl: head.band_head(**_thr(), x=torch.rand(NS, C), **WIN, query_tile=T,
                                             impl=impl, lists=_lists()),
    "band_head_bwd": lambda impl: head.band_head_bwd(**_thr(), g=torch.rand(NQ, C), **WIN,
                                                     query_tile=T, impl=impl, lists=_lists()),
    "band_conv": lambda impl: band_conv.band_conv(**_conv(), impl=impl),
    "band_conv_bwd": lambda impl: band_conv.band_conv_bwd(**_conv(), gs=torch.rand(NQ, C),
                                                          impl=impl),
    "radius_neighbors_pallas": lambda impl: neighbors.radius_neighbors_pallas(
        torch.rand(NQ, 3), torch.rand(NS, 3), torch.tensor([NQ]), torch.tensor([NS]), 0.3,
        max_k=8, num_clouds=1, impl=impl),
    "deform_sums": lambda impl: deform_conv.deform_sums(
        torch.rand(NQ, 3), torch.rand(NS, 3), torch.zeros((NQ, 8), dtype=torch.int64),
        torch.rand(NS, C), torch.rand(deform_conv.KP, 3), extent=1.0, drop=False, impl=impl),
}


@pytest.mark.parametrize("dispatcher", sorted(CALLS))
def test_unknown_impl_raises_before_any_route(dispatcher, monkeypatch):
    ran = []
    for mod, names in ROUTES.items():
        for name in names:
            monkeypatch.setattr(mod, name, lambda *a, _name=name, **kw: ran.append(_name))
    launches = neighbors.radius_neighbors_pallas.launches
    with pytest.raises(ValueError, match="impl must be"):
        CALLS[dispatcher]("twin")
    assert ran == [] and neighbors.radius_neighbors_pallas.launches == launches
