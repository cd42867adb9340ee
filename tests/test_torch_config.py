"""Port vs JAX: config, pyramid spec, model specs (pure host code)."""

import dataclasses

import pytest

from d3feat_tpu.config import D3FeatConfig as JConfig, PyramidCaps as JCaps
from d3feat_tpu.models.kpfcnn import make_kpfcnn_specs as j_specs
from d3feat_tpu.ops.pyramid import level_band_cap as j_band_cap, make_pyramid_spec as j_pspec
from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.models.kpfcnn import make_kpfcnn_specs
from d3feat_tpu_torch.ops.pyramid import level_band_cap, make_pyramid_spec
from tests.torch_port_helpers import jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

BENCH_CAPS = tuple(c * 2 for c in (16384, 8192, 2048, 768, 256))


def _configs():
    bench = JConfig(experiment_id="bench")
    bench.caps = JCaps(points=BENCH_CAPS, neighbors=(40,) * 5, corr=128)
    bench.query_tile = 512
    return {"default": JConfig(experiment_id="default"), "bench": bench,
            "small": jax_config(), "small3": jax_config(num_layers=3)}


@pytest.mark.parametrize("name", ["default", "bench", "small", "small3"])
def test_to_dict_matches_jax(name):
    jcfg = _configs()[name]
    tcfg = torch_config(jcfg)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.architecture() == jcfg.architecture()


def test_defaults_and_round_trip():
    assert D3FeatConfig(experiment_id="x").to_dict() == JConfig(experiment_id="x").to_dict()
    cfg = D3FeatConfig(experiment_id="x", num_layers=4)
    cfg.caps = PyramidCaps(points=(64, 32, 16, 8), neighbors=(5, 6, 7, 8), corr=3)
    assert D3FeatConfig.from_dict(cfg.to_dict()) == cfg


@pytest.mark.parametrize("name", ["default", "bench", "small", "small3"])
def test_pyramid_spec_matches_jax(name):
    jcfg = _configs()[name]
    js = j_pspec(jcfg, num_clouds=2)
    ts = make_pyramid_spec(torch_config(jcfg), num_clouds=2)
    for f in dataclasses.fields(ts):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name
    assert ts.radii == js.radii


@pytest.mark.parametrize("name", ["default", "small"])
def test_kpfcnn_specs_match_jax(name):
    jcfg = _configs()[name]
    js, ts = j_specs(jcfg), make_kpfcnn_specs(torch_config(jcfg))
    assert [dataclasses.astuple(b) for b in ts.encoder] == \
        [dataclasses.astuple(b) for b in js.encoder]
    assert [dataclasses.astuple(b) for b in ts.decoder] == \
        [dataclasses.astuple(b) for b in js.decoder]
    assert ts.encoder_skips == js.encoder_skips
    assert ts.decoder_concats == js.decoder_concats


@pytest.mark.parametrize("rows", [32, 512, 4096, 16384, 32768])
@pytest.mark.parametrize("tile,ratio", [(128, 1), (256, 1), (128, 2), (128, 4)])
def test_level_band_cap_matches_jax(rows, tile, ratio):
    assert level_band_cap(rows, 2, 0.1, tile=tile, ratio=ratio) == \
        j_band_cap(rows, 2, 0.1, tile=tile, ratio=ratio)
