"""Port vs JAX: batch norm (``use_batch_norm=True``).

(a) the masked norm (``models.blocks.BatchNorm``) against JAX's
    ``apply_norm`` on rows with padding: three train-mode updates (outputs
    and running statistics at atol 1e-6, momentum 0.1 so they move), then
    eval mode (atol 1e-6), and the train-mode gradients in the input, scale
    and offset against ``jax.grad`` (atol 1e-6, rtol 1e-6); statistics that
    counted the padding would be off by far more;
(b) a 3-layer BN KPFCNN on the band route (``force_band_export``), the JAX
    steps jitted once for the module: one train step given JAX's pyramid
    against ``make_train_step`` at ``test_torch_train_step.py``'s (a)
    tolerances (metrics rtol 1e-5, gradients atol 5e-4 / rtol 1e-3) with
    the new running statistics at atol 1e-6; a step on a pair with a NaN
    feature is skipped, yet its running statistics are kept, as the JAX
    step keeps ``new_model_state`` (both NaN where JAX's are);
(c) extraction with those running statistics against JAX's
    ``make_extract_step`` (descriptors and scores atol 1e-5), and the eval
    step, which must not move them;
(d) the portable npz with model state: the port's export loads in JAX's
    ``import_npz`` leaf for leaf, and JAX's export loads back into the port
    bit for bit;
(e) data parallelism with batch norm: world size 1 builds, two gloo ranks
    raise."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.blocks import apply_norm
from d3feat_tpu.train import init_train_state
from d3feat_tpu.train import make_extract_step as j_make_extract
from d3feat_tpu.train import make_train_step as j_make_train
from d3feat_tpu_torch.compat.weights import params_from_numpy, state_from_numpy
from d3feat_tpu_torch.models.blocks import BatchNorm
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
from d3feat_tpu_torch.train.step import TrainState, make_eval_step, make_extract_step, \
    make_train_step
from tests.torch_port_helpers import jax_band_spec, jax_config, jax_pyramid, pair_batch, \
    torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "lr", "skipped",
          "overflow")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_masked_norm_matches_apply_norm():
    rng = np.random.default_rng(0)
    n, d, valid, mom = 40, 8, 29, 0.1
    mask = np.arange(n) < valid
    params = {"scale": (1.0 + 0.3 * rng.normal(size=d)).astype(np.float32),
              "offset": (0.3 * rng.normal(size=d)).astype(np.float32)}
    state = {"mean": np.zeros(d, np.float32), "var": np.ones(d, np.float32)}
    bn = BatchNorm(d, mom, "cpu")
    with torch.no_grad():
        bn.scale.copy_(_t(params["scale"]))
        bn.offset.copy_(_t(params["offset"]))
    for _ in range(3):
        x = (rng.normal(size=(n, d)) + 0.5).astype(np.float32)
        x[~mask] += 2.0  # padding rows that a norm over all rows would count
        jy, state = apply_norm(params, state, jnp.asarray(x), jnp.asarray(mask), use_bn=True,
                               momentum=mom, train=True)
        ty = bn(_t(x), _t(mask), train=True)
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(state[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    unmasked = x.mean(0)
    assert np.abs(unmasked - x[:valid].mean(0)).max() > 1e-1
    # unit-scale rows: the sums run in another order than XLA's, so the
    # outputs agree to an ulp or two of their size, well inside 1e-6 here

    jy, same = apply_norm(params, state, jnp.asarray(x), jnp.asarray(mask), use_bn=True,
                          momentum=mom, train=False)
    before = {k: getattr(bn, k).clone() for k in ("mean", "var")}
    ty = bn(_t(x), _t(mask), train=False)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-6)
    assert all(torch.equal(getattr(bn, k), before[k]) for k in before)

    ct = rng.normal(size=(n, d)).astype(np.float32)

    def jloss(p, xx):
        y, _ = apply_norm(p, state, xx, jnp.asarray(mask), use_bn=True, momentum=mom,
                          train=True)
        return jnp.sum(y * ct)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (bn(xt, _t(mask), train=True) * _t(ct)).sum().backward()
    # the parameter gradients are sums over the rows (|g| up to ~20): an
    # ulp of their size besides the 1e-6
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(jg_p["scale"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bn.offset.grad.numpy(), np.asarray(jg_p["offset"]), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def jax_steps():
    jcfg = jax_config(LAYERS, use_batch_norm=True)
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    spec = jax_band_spec(jcfg)
    return (jcfg, ts, jax.jit(j_make_train(jcfg, specs, pyramid_spec=spec)),
            jax.jit(j_make_extract(jcfg, specs, pyramid_spec=spec)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jcfg, ts):
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict({**params_from_numpy(_np(ts.params)),
                           **state_from_numpy(_np(ts.model_state), model)})
    return tcfg, TrainState(model, make_optimizer(tcfg, model))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def _assert_state(model, jstate, atol=1e-6):
    want = state_from_numpy(_np(jstate), model)
    assert len(want) == 2 * 26  # mean and var of every batch norm of the 3-layer model
    bufs = dict(model.named_buffers())
    for name, v in want.items():
        np.testing.assert_allclose(bufs[name].numpy(), v.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def stepped(jax_steps):
    """JAX's and the port's state after one step on pair 3, the port's
    given JAX's pyramid; with the metrics of both."""
    jcfg, ts, jstep, _ = jax_steps
    _, _, pyr = jax_pyramid(3, LAYERS)
    b = pair_batch(3)
    ts2, jm = jstep(ts, _jbatch(b), jnp.int32(0))
    tcfg, state = _port_state(jcfg, ts)
    state, tm = make_train_step(tcfg)(state, _tbatch(b), 0,
                                      pyramid=torch_batch_from_jax(pyr, np.zeros((512, 1))))
    return ts, ts2, jm, tcfg, state, tm


def test_train_step_matches_jax(jax_steps, stepped):
    jcfg = jax_steps[0]
    ts, ts2, jm, _, state, tm = stepped
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5, err_msg=f)
    assert tm.skipped == 0.0 and state.step == int(ts2.step) == 1
    trace, params = params_from_numpy(_np(ts2.opt_state[-1].trace)), params_from_numpy(
        _np(ts.params))
    names = [n for n, _ in train_tensors(state.model)]
    assert sorted(names) == sorted(trace)
    assert sum(n.endswith((".scale", ".offset")) for n in names) == 2 * 26
    for name, t in train_tensors(state.model):
        g = trace[name] - jcfg.weight_decay * params[name]
        np.testing.assert_allclose(t.grad.numpy(), g.numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
    _assert_state(state.model, ts2.model_state)
    # the statistics moved from their initial 0 and 1
    assert float(state.model.encoder[0].norm.mean.abs().max()) > 1e-3


def test_skipped_step_keeps_the_running_statistics(jax_steps, stepped):
    _, _, jstep, _ = jax_steps
    _, ts2, _, tcfg, state, _ = stepped
    bad = pair_batch(5)
    bad["features"] = bad["features"].copy()
    bad["features"][0, 0] = np.nan
    ts3, jm = jstep(ts2, _jbatch(bad), jnp.int32(0))
    assert float(jm.skipped) == 1.0

    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(state.model.state_dict())
    st = TrainState(model, make_optimizer(tcfg, model), step=1)
    params = {n: t.detach().clone() for n, t in train_tensors(model)}
    before = {n: b.clone() for n, b in model.named_buffers() if n.endswith((".mean", ".var"))}
    st, m = make_train_step(tcfg)(st, _tbatch(bad), 0)
    assert m.skipped == 1.0 and st.step == 1
    assert all(torch.equal(t.detach(), params[n]) for n, t in train_tensors(model))
    bufs = dict(model.named_buffers())
    assert not all(torch.equal(bufs[n], before[n]) for n in before)
    want = state_from_numpy(_np(ts3.model_state), model)
    for name, v in want.items():  # NaN wherever JAX's are
        np.testing.assert_array_equal(np.isnan(bufs[name].numpy()), np.isnan(v.numpy()))
        np.testing.assert_allclose(bufs[name].numpy(), v.numpy(), rtol=0, atol=1e-6)


def test_extraction_matches_jax_with_running_statistics(jax_steps, stepped):
    _, _, _, jextract = jax_steps
    _, ts2, _, tcfg, state, _ = stepped
    b = pair_batch(7)
    jf, js, jo = jextract(ts2.params, ts2.model_state,
                          {k: jnp.asarray(b[k]) for k in ("points", "features", "lengths")})
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict({**params_from_numpy(_np(ts2.params)),
                           **state_from_numpy(_np(ts2.model_state), model)})
    before = {n: b_.clone() for n, b_ in model.named_buffers()}
    tf, tsc, to = make_extract_step(tcfg)(model, {k: _t(b[k]) for k in
                                                  ("points", "features", "lengths")})
    assert bool(to) == bool(jo) is False
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tsc.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    assert (np.asarray(js) > 0).sum() > 20
    make_eval_step(tcfg)(model, _tbatch(pair_batch(7)))
    assert all(torch.equal(b_, before[n]) for n, b_ in model.named_buffers())


def test_npz_round_trip_with_state(jax_steps, stepped, tmp_path):
    from d3feat_tpu.compat.portable import export_npz as j_export_npz
    from d3feat_tpu.compat.portable import import_npz as j_import_npz
    from d3feat_tpu_torch.compat.portable import read_npz
    from d3feat_tpu_torch.compat.weights import export_model_npz, load_npz, model_trees

    _, ts, *_ = stepped
    tcfg, state = stepped[3], stepped[4]
    path = str(tmp_path / "port.npz")
    export_model_npz(path, state.model, meta={"epoch": 2})
    jp, js, meta = j_import_npz(path, ts.params, ts.model_state)
    assert meta == {"epoch": 2}
    params, mstate = model_trees(state.model)
    assert len(mstate) == 2 * 26 and not any(k.endswith((".mean", ".var")) for k in params)
    for got, want in ((params_from_numpy(_np(jp)), params),
                      (state_from_numpy(_np(js), state.model), dict(
                          (n, b) for n, b in state.model.named_buffers()
                          if n.endswith((".mean", ".var"))))):
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in got)

    back = str(tmp_path / "jax.npz")
    j_export_npz(back, jp, js, meta={"epoch": 3})
    assert read_npz(back)[1].keys() == read_npz(path)[1].keys()
    model = init_kpfcnn(tcfg, device="cpu")
    assert load_npz(model, back) == {"epoch": 3}
    sd, want = model.state_dict(), state.model.state_dict()
    assert sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in sd)


_DP = r'''
import os, sys
import torch
import torch.distributed as dist
from d3feat_tpu_torch.parallel.data_parallel import make_dp_train_step
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
cfg = torch.load(sys.argv[4], weights_only=False)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
try:
    make_dp_train_step(cfg)
    print("built")
except NotImplementedError as e:
    print("raised:", e)
dist.destroy_process_group()
'''


@pytest.mark.parametrize("world", [1, 2])
def test_data_parallel_batch_norm(tmp_path, world):
    cfg_path = str(tmp_path / "cfg.pt")
    torch.save(torch_config(jax_config(LAYERS, use_batch_norm=True)), cfg_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _DP, str(r), str(world),
                               str(tmp_path / "store"), cfg_path], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for out in outs:
        if world == 1:
            assert "built" in out, out
        else:
            assert "raised:" in out and "batch-norm" in out, out
