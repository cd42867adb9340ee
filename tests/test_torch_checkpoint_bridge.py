"""Port vs JAX: the reference ``.pth`` bridges. The port's
``compat.torch_export.export_state_dict`` of a model carried across with
``params_from_numpy``/``state_from_numpy`` against JAX's export of the same
trees (keys in order, shapes, dtypes, values bit for bit), with batch norm
off, on, and a deformable (and modulated) config; the port's
``convert_state_dict`` of JAX's export against JAX's ``convert_state_dict``
carried across; ``.pth`` files written by each package loaded by the
other, meta included; the missing-key and leftover-key errors; a modulated
checkpoint refused by a non-modulated config. The 3-layer, width-32
configs of ``tests/test_torch_export.py``; JAX's ``init_kpfcnn`` runs
eagerly, nothing is jitted."""

import jax
import numpy as np
import pytest
import torch

from d3feat_tpu.compat.torch_export import export_state_dict as j_export
from d3feat_tpu.compat.torch_export import save_torch_checkpoint as j_save
from d3feat_tpu.compat.torch_import import convert_state_dict as j_convert
from d3feat_tpu.compat.torch_import import load_torch_checkpoint as j_load
from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.config import PyramidCaps as JCaps
from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
from d3feat_tpu_torch.compat.torch_export import export_state_dict, save_torch_checkpoint
from d3feat_tpu_torch.compat.torch_import import convert_state_dict, load_torch_checkpoint
from d3feat_tpu_torch.compat.weights import params_from_numpy, state_from_numpy
from d3feat_tpu_torch.config import D3FeatConfig as TConfig
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

# level 2's blocks deformable: a deformable strided conv and a deformable conv
DEFORM_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb",
               "resnetb_deformable_strided", "resnetb_deformable", "resnetb_deformable",
               "nearest_upsample", "unary", "nearest_upsample", "last_unary"]


class JDeform(JConfig):
    def architecture(self):
        return list(DEFORM_ARCH)


class TDeform(TConfig):
    def architecture(self):
        return list(DEFORM_ARCH)


def _configs(kind="plain", modulated=False):
    """(JAX config, the port's) as ``tests/test_torch_export.py::_cfg``
    builds them: 3 layers, width 32; ``kind`` 'plain', 'bn' or 'deform'."""
    jcfg = (JDeform if kind == "deform" else JConfig)()
    jcfg.num_layers = 3
    jcfg.first_features_dim = 32
    jcfg.use_batch_norm = kind == "bn"
    jcfg.modulated = modulated
    jcfg.caps = JCaps(points=(2048,) * 3, neighbors=(16,) * 3, corr=32)
    return jcfg, (TDeform if kind == "deform" else TConfig).from_dict(jcfg.to_dict())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trees(jcfg, seed):
    """JAX's (params, state, specs) with every leaf redrawn from a seeded
    generator, so the norms' scales, offsets, biases and running
    statistics are not their constant initial values."""
    params, state, specs = j_init(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        return (rng.uniform(0.5, 1.5, x.shape) if x.ndim == 1 else
                x + rng.normal(0.0, 0.01, x.shape)).astype(np.float32)

    return jax.tree.map(draw, params), jax.tree.map(draw, state), specs


def _port_model(tcfg, params, state):
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict({**params_from_numpy(_np(params)),
                           **state_from_numpy(_np(state), model)}, strict=True)
    return model


def _same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def _same_state_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["plain", "bn", "deform"])
def test_export_matches_jax(kind):
    jcfg, tcfg = _configs(kind)
    params, state, specs = _trees(jcfg, 0)
    model = _port_model(tcfg, params, state)
    want = j_export(params, state, jcfg, specs)
    got = export_state_dict(model, tcfg)
    _same_dict(got, want)
    assert (kind == "bn") == any("running_var" in k for k in got)
    assert (kind == "deform") == any("offset_conv" in k for k in got)


@pytest.mark.parametrize("kind", ["plain", "bn", "deform"])
def test_convert_matches_jax(kind):
    jcfg, tcfg = _configs(kind)
    params, state, specs = _trees(jcfg, 1)
    sd = j_export(params, state, jcfg, specs)
    jp, js = j_convert(sd, jcfg, specs, strict=True)
    model = init_kpfcnn(tcfg, device="cpu")
    want = {**params_from_numpy(_np(jp)), **state_from_numpy(_np(js), model)}
    got = convert_state_dict(sd, tcfg, strict=True)
    _same_state_dict(got, want)
    assert set(got) == set(model.state_dict())
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    # the reference's torch tensors convert as its numpy arrays do
    as_torch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    _same_state_dict(convert_state_dict(as_torch, tcfg), want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pth_across_packages(writer, tmp_path):
    jcfg, tcfg = _configs("bn")
    params, state, specs = _trees(jcfg, 2)
    model = _port_model(tcfg, params, state)
    path = str(tmp_path / "export.pth")
    if writer == "jax":
        j_save(path, params, state, jcfg, specs, epoch=7, best_loss=1.25)
    else:
        save_torch_checkpoint(path, model, tcfg, epoch=7, best_loss=1.25)
    loaded, meta = load_torch_checkpoint(path, tcfg, device="cpu")
    assert meta == {"epoch": 7, "best_loss": 1.25}
    _same_state_dict(loaded.state_dict(), model.state_dict())
    jp, js, jmeta = j_load(path, jcfg, specs)
    assert jmeta == meta
    _same_state_dict(params_from_numpy(_np(jp)), params_from_numpy(_np(params)))
    _same_state_dict(params_from_numpy(_np(js)), params_from_numpy(_np(state)))
    # a bare state_dict loads too, with no meta
    torch.save(torch.load(path, weights_only=False)["state_dict"], path)
    bare, meta = load_torch_checkpoint(path, tcfg, device="cpu")
    assert meta == {}
    _same_state_dict(bare.state_dict(), model.state_dict())


def test_missing_and_leftover_keys_match_jax():
    jcfg, tcfg = _configs("bn")
    params, state, specs = j_init(jax.random.key(3), jcfg)
    sd = j_export(params, state, jcfg, specs)
    for drop in ("encoder_blocks.1.unary2.batch_norm.batch_norm.running_var",
                 "decoder_blocks.3.mlp.weight"):
        cut = {k: v for k, v in sd.items() if k != drop}
        with pytest.raises(KeyError) as jerr:
            j_convert(cut, jcfg, specs)
        with pytest.raises(KeyError) as terr:
            convert_state_dict(cut, tcfg)
        assert str(terr.value) == str(jerr.value) == repr(f"checkpoint is missing {drop!r}")
    extra = dict(sd, **{f"stray.{i}": np.zeros(2, np.float32) for i in range(10)})
    with pytest.raises(ValueError) as jerr:
        j_convert(extra, jcfg, specs)
    with pytest.raises(ValueError, match="unconverted checkpoint keys") as terr:
        convert_state_dict(extra, tcfg)
    assert str(terr.value) == str(jerr.value) and str(terr.value).endswith("...")
    # not strict: the leftovers are ignored; num_batches_tracked never counts
    _same_state_dict(convert_state_dict(extra, tcfg, strict=False), convert_state_dict(sd, tcfg))
    assert any("num_batches_tracked" in k for k in sd)


def test_modulated_checkpoint_refused_by_an_unmodulated_config(tmp_path):
    _, mcfg = _configs("deform", modulated=True)
    _, ucfg = _configs("deform", modulated=False)
    path = str(tmp_path / "modulated.pth")
    save_torch_checkpoint(path, init_kpfcnn(mcfg, device="cpu"), mcfg)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_torch_checkpoint(path, ucfg, device="cpu")
    model, _ = load_torch_checkpoint(path, mcfg, device="cpu")
    assert model.encoder[5].conv.offset_weights.shape[-1] == 4 * 15
