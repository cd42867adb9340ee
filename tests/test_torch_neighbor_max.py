"""K7, the neighbourhood max (``ops/neighbor_max.py``): the strided blocks'
max pools and the detector's local-max gate.

On the CPU:

(a) the twin ``neighbor_max_plain`` equals, bit for bit, the two
    expressions the port ran before it (copied here): the max pool's
    ``gather_rows(x, inds).amax(1)`` and the gate's index of the
    zero-extended features, over lists 1-256 wide and 32-1,024 channels,
    with shadows, all-shadow rows, negative rows and NaN; its gradient
    equals the max pool's;
(b) which calls ``neighbor_max`` sends to K7 (``uses_kernel``) and which
    counter each call moves;
(c) an eval forward and a train step on the CPU take every neighbourhood
    max by the twin: once a strided block, and once more for the gate.

On the card (marker ``cuda``, skipped without one; from the root of a
checkout: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_neighbor_max.py``): K7 equals the twin under
``torch.equal`` on the pool and conv0 lists of a group of 8 eval-cache
fragments at the 32,768-a-fragment bucket, for the rigid and the
deformable served configurations (``benchmark/configs/``), at their
widths; all-shadow rows and NaN as in the twin; the scalar route
(channels not a multiple of 4, rows not 16-byte aligned); one extraction
group launches K7 5 times and the twin never; a train step runs only the
twin.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.data.pack import pack_fragments, pack_pair
from d3feat_tpu_torch.data.synthetic import synthetic_pair
from d3feat_tpu_torch.eval.extract import FeatureExtractor
from d3feat_tpu_torch.models.kpconv import gather_rows
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn, make_kpfcnn_specs
from d3feat_tpu_torch.ops.neighbor_max import (neighbor_max, neighbor_max_plain,
                                               uses_kernel)
from d3feat_tpu_torch.train.optim import make_optimizer
from d3feat_tpu_torch.train.step import TrainState, make_extract_step, make_train_step
from tests.torch_port_helpers import CAPS, N_POINTS, NEIGHBORS
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _old_max_pool(x, inds):
    """``models/blocks.py::max_pool`` before K7."""
    return gather_rows(x, inds).amax(1)


def _old_gate_max(f, neighbor):
    """The local-max gate's neighbourhood max before K7
    (``models/kpfcnn.py::detection_scores``)."""
    f_ext = torch.cat([f, f.new_zeros((1, f.shape[1]))])
    return f_ext[neighbor.long()].amax(1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _case(kind, k, c, nq=16, ns=300, seed=0):
    """(x [ns, c] float32, inds [nq, k] int32) with the shadow ``ns``."""
    rng = np.random.default_rng(seed + k + c)
    x = rng.standard_normal((ns, c)).astype(np.float32)
    inds = rng.integers(0, ns, size=(nq, k)).astype(np.int32)
    inds[rng.random((nq, k)) < 0.25] = ns  # shadows among the rows
    if kind == "all_shadow":
        inds[::3] = ns  # padding queries: only the shadow
    elif kind == "negative":
        x = -np.abs(x) - 0.5  # every row below 0: a shadow's 0 wins where listed
        inds[1::2] = rng.integers(0, ns, size=inds[1::2].shape)  # and lists with none
    elif kind == "nan":
        rows = rng.integers(0, ns, size=7)
        x[rows, rng.integers(0, c, size=7)] = np.nan
        inds[0, 0] = rows[0]  # a NaN listed
    return torch.from_numpy(x), torch.from_numpy(inds)


# --- (a) the twin against the expressions it replaced ----------------------


@pytest.mark.parametrize("kind", ["shadows", "all_shadow", "negative", "nan"])
@pytest.mark.parametrize("c", [32, 128, 1024])
@pytest.mark.parametrize("k", [1, 40, 145, 256])
def test_twin_equals_the_old_expressions(k, c, kind):
    x, inds = _case(kind, k, c)
    got = neighbor_max_plain(x, inds)
    assert got.shape == (inds.shape[0], c) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(_old_max_pool(x, inds)))
    assert torch.equal(_bits(got), _bits(_old_gate_max(x, inds)))
    if kind == "all_shadow":
        assert torch.equal(got[::3], torch.zeros_like(got[::3]))
    if kind == "negative":
        listed = (inds == x.shape[0]).any(1)
        assert bool((got[listed] == 0).all()) and bool((got[~listed] < 0).all())
    if kind == "nan":
        assert bool(got.isnan().any())


def test_twin_gradient_equals_the_max_pools():
    x, inds = _case("shadows", 40, 128)
    g = torch.randn((inds.shape[0], 128), generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (neighbor_max_plain, _old_max_pool):
        xr = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xr, inds), xr, g)[0])
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    assert float(grads[0].abs().sum()) > 0.0


# --- (b) the decision ------------------------------------------------------


@pytest.mark.parametrize("impl, grad, dtype, want", [
    ("auto", False, torch.float32, "twin"),       # a CPU tensor
    ("auto", True, torch.float32, "twin"),        # and a gradient is needed
    ("auto", False, torch.bfloat16, "twin"),
    ("plain", False, torch.float32, "twin"),
    ("plain", True, torch.float32, "twin"),
    ("kernel", False, torch.float32, "kernel"),   # K7, which takes CUDA tensors only
    ("kernel", True, torch.float32, "refused"),   # K7 keeps no gradient
    ("kernel", False, torch.bfloat16, "refused"),
    ("twin", False, torch.float32, "refused"),    # no such impl
])
def test_decision_and_counters(impl, grad, dtype, want):
    x, inds = _case("shadows", 40, 32)
    x = x.to(dtype).requires_grad_(grad)
    before = (neighbor_max.launches, neighbor_max.launches_fallback)
    if want == "twin":
        assert not uses_kernel(impl, x, inds)
        got = neighbor_max(x, inds, impl)
        assert torch.equal(got, neighbor_max_plain(x, inds))
        assert (neighbor_max.launches, neighbor_max.launches_fallback) == (before[0],
                                                                          before[1] + 1)
        return
    if want == "kernel":
        assert uses_kernel(impl, x, inds)
        with pytest.raises(ValueError, match="CUDA"):
            neighbor_max(x, inds, impl)
    else:
        with pytest.raises(ValueError):
            neighbor_max(x, inds, impl)
    assert (neighbor_max.launches, neighbor_max.launches_fallback) == before


# --- (c) the model's calls on the CPU --------------------------------------


LAYERS = 3


def _small_config():
    cfg = D3FeatConfig(experiment_id="port-test")
    cfg.num_layers = LAYERS
    cfg.first_features_dim = 16
    cfg.first_subsampling_dl = 0.1
    cfg.caps = PyramidCaps(points=CAPS[:LAYERS], neighbors=(NEIGHBORS,) * LAYERS, corr=8)
    cfg.query_tile = 128
    return cfg


def _strided(cfg):
    return sum(s.strided for s in make_kpfcnn_specs(cfg).encoder)


def _small_pair(device):
    rng = np.random.default_rng(3)
    p0, p1, corr, dk = synthetic_pair(rng, n_points=N_POINTS, num_corr=8, extent=2.0)
    ones = np.ones((N_POINTS, 1), np.float32)
    packed = pack_pair(p0, p1, ones, ones, corr, dk, point_capacity=CAPS[0], corr_capacity=8)
    return {k: torch.from_numpy(np.asarray(getattr(packed, k))).to(device)
            for k in packed._fields}


def _counted(fn):
    before = (neighbor_max.launches, neighbor_max.launches_fallback)
    out = fn()
    return out, (neighbor_max.launches - before[0], neighbor_max.launches_fallback - before[1])


def test_eval_forward_and_train_step_take_the_twin_on_the_cpu():
    cfg = _small_config()
    batch = _small_pair("cpu")
    model = init_kpfcnn(cfg, seed=1, device="cpu")
    n = _strided(cfg)
    assert n == LAYERS - 1
    _, c = _counted(lambda: make_extract_step(cfg)(model, batch))
    assert c == (0, n + 1)  # the pools and the gate
    state = TrainState(model, make_optimizer(cfg, model))
    _, c = _counted(lambda: make_train_step(cfg)(state, batch, 0))
    assert c == (0, n)  # the training head has no gate


# --- on the card -----------------------------------------------------------

GROUP, BUCKET = 8, 32768


def _served_config(name):
    """The served configuration of ``benchmark/configs/<name>.json``, its
    block list included."""
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as fh:
        doc = json.load(fh)
    arch = doc.get("architecture")

    class Served(D3FeatConfig):
        def architecture(self):
            return list(arch) if arch else D3FeatConfig.architecture(self)

    return Served.from_dict(doc)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def group(card):
    """8 eval-cache fragments that the extractor serves at the 32,768 bucket."""
    from d3feat_tpu_torch.data.pack import load_eval_fragments

    frags = load_eval_fragments(BUCKET // 2 + 1, BUCKET)[:GROUP]
    assert len(frags) == GROUP
    return frags


@pytest.fixture(scope="module", params=["d3feat-3dmatch", "d3feat-3dmatch-deform"])
def served(request, card, group):
    """(configuration, its pyramid of ``group`` at the 32,768 bucket)."""
    from d3feat_tpu_torch.eval.extract import _bucket_caps
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    cfg = _served_config(request.param)
    cfg_b = dataclasses.replace(cfg, caps=_bucket_caps(cfg, GROUP * BUCKET))
    b = pack_fragments(group, point_capacity=GROUP * BUCKET, num_clouds=GROUP)
    pyr = build_pyramid(torch.from_numpy(b["points"]).to(card),
                        torch.from_numpy(b["lengths"]).to(card),
                        spec=make_pyramid_spec(cfg_b, num_clouds=GROUP))
    assert not bool(pyr["overflow"])
    return cfg, pyr


def _features(rows, c, card, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((rows, c), generator=g, device=card)
    x[::5] = -x[::5].abs()  # rows below 0: the shadow's 0 wins where listed
    return x


def _cases(cfg, pyr):
    """(label, the level the lists index, lists, channels): each strided
    block's pool lists at its input width, and conv0's lists at the gate's
    width."""
    out = [(f"pool{s.layer}", s.layer, pyr["pools"][s.layer], s.in_dim)
           for s in make_kpfcnn_specs(cfg).encoder if s.strided]
    return out + [("gate", 0, pyr["neighbors"][0], cfg.output_dim)]


@pytest.mark.cuda
def test_k7_equals_the_twin_on_a_served_group(card, served):
    cfg, pyr = served
    cases = _cases(cfg, pyr)
    assert len(cases) == 5
    for i, (label, level, inds, c) in enumerate(cases):
        rows = pyr["points"][level].shape[0]  # the lists' shadow
        assert inds.dtype == torch.int32 and int(inds.max()) == rows
        x = _features(rows, c, card, seed=i)
        before = neighbor_max.launches
        got = neighbor_max(x, inds, "kernel")
        want = neighbor_max_plain(x, inds)
        torch.cuda.synchronize()
        assert neighbor_max.launches == before + 1
        assert torch.equal(got, want), label


@pytest.mark.cuda
def test_k7_all_shadow_rows_and_nan(card, served):
    cfg, pyr = served
    for i, (_, level, inds, c) in enumerate(_cases(cfg, pyr)[2:]):
        rows = pyr["points"][level].shape[0]
        inds = inds.clone()
        inds[::3] = rows  # all shadow
        x = _features(rows, c, card, seed=10 + i)
        nan_rows = inds[1::3, 0]
        x[nan_rows[nan_rows < rows].long(), : c // 2] = float("nan")
        got, want = neighbor_max(x, inds, "kernel"), neighbor_max_plain(x, inds)
        torch.cuda.synchronize()
        assert torch.equal(got[::3], torch.zeros_like(got[::3]))
        assert torch.equal(got.isnan(), want.isnan()) and bool(want.isnan().any())
        ok = ~want.isnan()
        assert torch.equal(got[ok], want[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("c, k, offset", [(30, 40, 0), (32, 40, 1), (3, 1, 0), (1, 256, 0),
                                          (2048, 40, 0), (1024, 145, 0), (64, 256, 0)])
def test_k7_scalar_and_wide_routes(card, c, k, offset):
    ns, nq = 4096, 2048
    g = torch.Generator(device=card).manual_seed(c + k)
    base = torch.randn((ns * c + offset,), generator=g, device=card)
    x = base[offset:].view(ns, c)  # offset 1: rows not 16-byte aligned
    inds = torch.randint(0, ns + 1, (nq, k), generator=g, device=card, dtype=torch.int32)
    inds[-64:] = ns
    got, want = neighbor_max(x, inds, "kernel"), neighbor_max_plain(x, inds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["d3feat-3dmatch", "d3feat-3dmatch-deform"])
def test_an_extraction_group_launches_k7_five_times(card, group, name):
    cfg = _served_config(name)
    ex = FeatureExtractor(cfg, init_kpfcnn(cfg, seed=1, device=card),
                          batch_fragments=GROUP, device=card)
    ex.extract_many(group)  # builds the bucket's step and captures its pyramid
    _, c = _counted(lambda: ex.extract_many(group))
    assert list(ex._steps) == [(GROUP * BUCKET, GROUP)]
    assert c == (5, 0)


@pytest.mark.cuda
def test_a_train_step_takes_only_the_twin(card):
    cfg = _small_config()
    model = init_kpfcnn(cfg, seed=1, device=card)
    state = TrainState(model, make_optimizer(cfg, model))
    _, c = _counted(lambda: make_train_step(cfg)(state, _small_pair(card), 0))
    assert c == (0, _strided(cfg))
