"""Port vs JAX: the train and eval steps (3 layers, the shared test pair,
the JAX steps jitted once per module with the band pyramid and the Pallas
kernels in interpret mode). Both stacks start from the same JAX-initialised
parameters (``params_from_numpy``).

(a) given the JAX pyramid: loss and metrics at rtol 1e-5, every gradient
    (read from JAX's first momentum trace, g = trace - wd * p) at atol
    5e-4 / rtol 1e-3, updated parameters and momentum at atol 2e-6;
(b) from raw packed points (each stack builds its own pyramid, so the
    voxel-order ulps of ROADMAP Queue 3 are in): loss at rtol 1e-3, flat
    gradients at atol 5e-3 / rtol 5e-3 (``tests/test_band_conv_grad.py``'s
    whole-network tolerance);
(c) 5 steps on one pair lower the loss;
(d) a NaN in one input feature: both report ``skipped`` 1; the port's
    parameters, optimizer state and step count stay as they were;
(e) the eval step's metrics equal JAX's at rtol 1e-5;
(f) batch norm builds (its checks: ``tests/test_torch_batch_norm.py``) and
    an unknown compute dtype raises;
(g) the port's ``Trainer`` against JAX's ``Trainer`` on this module's
    jitted band-route steps: two epochs, epoch meters, snapshots, meta,
    ``metrics.jsonl`` tags and final weights."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.train import init_train_state, make_eval_step as j_make_eval
from d3feat_tpu.train import make_train_step as j_make_train
from d3feat_tpu_torch.compat.weights import optimizer_state_by_name, params_from_numpy
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
from d3feat_tpu_torch.train.step import TrainState, make_eval_step, make_train_step
from tests.torch_port_helpers import jax_band_spec, jax_config, jax_pyramid, pair_batch, \
    torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3
FIELDS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "lr", "skipped",
          "overflow")


@pytest.fixture(scope="module")
def jax_steps():
    jcfg = jax_config(LAYERS)
    ts, specs = init_train_state(jax.random.key(0), jcfg)
    spec = jax_band_spec(jcfg)
    return (jcfg, ts, jax.jit(j_make_train(jcfg, specs, pyramid_spec=spec)),
            jax.jit(j_make_eval(jcfg, specs, pyramid_spec=spec)))


def _np(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def _port_state(jcfg, params):
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(_np(params))
    return tcfg, TrainState(model, make_optimizer(tcfg, model))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in b.items()}


def _jax_grads(jcfg, ts, ts2):
    """Gradients of the JAX step: its first momentum trace is g + wd * p."""
    trace, params = _np(ts2.opt_state[-1].trace), _np(ts.params)
    return {k: trace[k] - jcfg.weight_decay * params[k] for k in trace}


def test_train_step_given_jax_pyramid_matches_jax(jax_steps):
    jcfg, ts, jstep, _ = jax_steps
    _, _, pyr = jax_pyramid(3, LAYERS)
    b = pair_batch(3)
    ts2, jm = jstep(ts, _jbatch(b), jnp.int32(0))
    tcfg, state = _port_state(jcfg, ts.params)
    state, tm = make_train_step(tcfg)(state, _tbatch(b), 0,
                                      pyramid=torch_batch_from_jax(pyr, np.zeros((512, 1))))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5, err_msg=f)
    assert state.step == int(ts2.step) == 1

    jgrads = _jax_grads(jcfg, ts, ts2)
    new_params, trace = _np(ts2.params), _np(ts2.opt_state[-1].trace)
    momentum = optimizer_state_by_name(state.model, state.optimizer)["momentum_buffer"]
    names = [n for n, _ in train_tensors(state.model)]
    assert sorted(names) == sorted(jgrads)
    for name, t in train_tensors(state.model):
        np.testing.assert_allclose(t.grad.numpy(), jgrads[name].numpy(), atol=5e-4, rtol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(t.detach().numpy(), new_params[name].numpy(), atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(momentum[name].numpy(), trace[name].numpy(), atol=2e-6,
                                   err_msg=name)
    assert max(float(jgrads[n].abs().max()) for n in names) > 1e-2


@pytest.mark.parametrize("seed", [3, 5, 7])
def test_train_step_from_raw_points_matches_jax(jax_steps, seed):
    jcfg, ts, jstep, _ = jax_steps
    b = pair_batch(seed)
    ts2, jm = jstep(ts, _jbatch(b), jnp.int32(0))
    tcfg, state = _port_state(jcfg, ts.params)
    state, tm = make_train_step(tcfg)(state, _tbatch(b), 0)
    assert tm.skipped == float(jm.skipped) == 0.0
    assert tm.overflow == float(jm.overflow) == 0.0
    np.testing.assert_allclose(tm.loss, float(jm.loss), rtol=1e-3)
    jgrads = _jax_grads(jcfg, ts, ts2)
    names = [n for n, _ in train_tensors(state.model)]
    flat_t = np.concatenate([t.grad.numpy().ravel() for _, t in train_tensors(state.model)])
    flat_j = np.concatenate([jgrads[n].numpy().ravel() for n in names])
    np.testing.assert_allclose(flat_t, flat_j, atol=5e-3, rtol=5e-3)


def test_five_steps_lower_the_loss():
    jcfg = jax_config(LAYERS)
    tcfg = torch_config(jcfg)
    model = init_kpfcnn(tcfg, seed=0, device="cpu")
    state = TrainState(model, make_optimizer(tcfg, model))
    step = make_train_step(tcfg)
    batch = _tbatch(pair_batch(3))
    losses = []
    for _ in range(5):
        state, m = step(state, batch, 0)
        assert np.isfinite(m.loss) and m.skipped == 0.0 and m.overflow == 0.0
        losses.append(m.loss)
    assert state.step == 5
    assert losses[-1] < losses[0]


def test_nonfinite_gradient_skips_the_update(jax_steps):
    jcfg, ts, jstep, _ = jax_steps
    good, bad = pair_batch(5), pair_batch(5)
    bad["features"] = bad["features"].copy()
    bad["features"][0, 0] = np.nan
    _, jm = jstep(ts, _jbatch(bad), jnp.int32(0))
    assert float(jm.skipped) == 1.0

    tcfg, state = _port_state(jcfg, ts.params)
    step = make_train_step(tcfg)
    state, _ = step(state, _tbatch(good), 0)
    params = {n: t.detach().clone() for n, t in train_tensors(state.model)}
    momentum = {n: v.clone() for n, v in optimizer_state_by_name(
        state.model, state.optimizer)["momentum_buffer"].items()}
    state, tm = step(state, _tbatch(bad), 0)
    assert tm.skipped == 1.0 and state.step == 1
    after = optimizer_state_by_name(state.model, state.optimizer)["momentum_buffer"]
    for n, t in train_tensors(state.model):
        assert torch.equal(t.detach(), params[n]), n
        assert torch.equal(after[n], momentum[n]), n


def test_eval_step_matches_jax(jax_steps):
    jcfg, ts, _, jeval = jax_steps
    _, _, pyr = jax_pyramid(3, LAYERS)
    b = pair_batch(3)
    jm = jeval(ts.params, ts.model_state, _jbatch(b))
    tcfg, state = _port_state(jcfg, ts.params)
    tm = make_eval_step(tcfg)(state.model, _tbatch(b),
                              pyramid=torch_batch_from_jax(pyr, np.zeros((512, 1))))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm, f), float(getattr(jm, f)), rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("field,value", [("use_batch_norm", True)])
def test_unported_settings_raise(field, value):
    """Batch norm is ported (``tests/test_torch_batch_norm.py``): the steps
    build with it, and a compute dtype the port lacks still raises."""
    tcfg = torch_config(jax_config(LAYERS, **{field: value}))
    for make in (make_train_step, make_eval_step):
        make(tcfg)
        with pytest.raises(ValueError, match="compute_dtype"):
            make(torch_config(jax_config(LAYERS, compute_dtype="float16", **{field: value})))


def test_trainer_matches_jax_trainer(jax_steps, tmp_path):
    """Both ``Trainer``s from the same JAX-initialised weights, 2 epochs of
    2 steps and 1 validation step on equal ``SyntheticPairDataset``
    loaders, a snapshot every epoch. JAX's ``Trainer`` is given the band
    route from the test side: its steps are this module's jitted band-route
    steps (``jax_steps``; JAX's ``make_pyramid_spec`` takes the CPU route
    on the CPU). Each epoch's train meters and validation results agree at
    (b)'s loss tolerance (rtol 1e-3), the snapshot names, their meta
    epochs and best choices, and ``metrics.jsonl``'s tags are the same.
    Final weights: each step's gradient may differ by atol + rtol |g|
    (5e-3 each, (b)'s tolerance), and SGD with momentum m moves a weight by
    lr times the momentum trace, so after steps k = 1..4 the weights may
    differ by at most lr * sum_k sum_{j<=k} m^(k-j) (5e-3 + 5e-3 G_j), G_j
    the largest |gradient| of step j (the port's)."""
    from d3feat_tpu.data.loader import PairLoader as JPairLoader
    from d3feat_tpu.data.synthetic import SyntheticPairDataset as JSynthetic
    from d3feat_tpu.train.trainer import Trainer as JTrainer
    from d3feat_tpu_torch.data.loader import PairLoader
    from d3feat_tpu_torch.data.synthetic import SyntheticPairDataset
    from d3feat_tpu_torch.train.trainer import Trainer
    from tests.torch_port_helpers import CAPS, N_POINTS

    _, _, jstep, jeval = jax_steps

    def config(root):
        c = jax_config(LAYERS)
        c.max_epoch, c.training_max_iter, c.val_max_iter, c.snapshot_interval = 2, 2, 1, 1
        c.snapshot_root, c.experiment_id, c.verbose = str(root), "run", False
        return c

    def loaders(loader_cls, ds_cls):
        return [loader_cls(ds_cls(size=size, n_points=N_POINTS, num_corr=8, seed=seed),
                           point_capacity=CAPS[0], corr_capacity=8, num_workers=2, seed=seed)
                for size, seed in ((4, 0), (2, 1))]

    def record(tr):
        epochs = []
        train_epoch, evaluate = tr.train_epoch, tr.evaluate
        tr.train_epoch = lambda e: epochs.append({"train": train_epoch(e)}) or epochs[-1]["train"]
        tr.evaluate = lambda e: epochs[-1].setdefault("val", evaluate(e))
        return epochs

    jcfg = config(tmp_path / "jax")
    jt = JTrainer(jcfg, *loaders(JPairLoader, JSynthetic))
    first = lambda b: jax.tree.map(lambda x: x[0], b)  # noqa: E731
    jt._train_step = lambda s, b, e: jstep(s, first(b), e)
    jt._eval_step = lambda p, m, b: jeval(p, m, first(b))
    pt = Trainer(torch_config(config(tmp_path / "port")), *loaders(PairLoader, SyntheticPairDataset),
                 device="cpu")
    pt.state.model.load_state_dict(_np(jt.state.params))
    gmax = []
    step = pt._train_step

    def port_step(state, batch, epoch):
        state, m = step(state, batch, epoch)
        gmax.append(max(float(t.grad.abs().max()) for _, t in train_tensors(state.model)))
        return state, m

    pt._train_step = port_step
    j_epochs, p_epochs = record(jt), record(pt)
    jstate = jt.train()
    pt.train()

    assert len(j_epochs) == len(p_epochs) == 2 and len(gmax) == 4
    for je, pe in zip(j_epochs, p_epochs):
        for part in ("train", "val"):
            assert sorted(je[part]) == sorted(pe[part])
            for k, v in je[part].items():
                np.testing.assert_allclose(pe[part][k], v, rtol=1e-3, atol=1e-6, err_msg=k)
        assert pe["train"]["skipped"] == 0.0
    jdir, pdir = (os.path.join(str(tmp_path / s), "run") for s in ("jax", "port"))
    snaps = sorted(f for f in os.listdir(jdir) if f.endswith(".meta.json"))
    assert snaps == sorted(f for f in os.listdir(pdir) if f.endswith(".meta.json"))
    assert {"snapshot_epoch_1.meta.json", "snapshot_epoch_2.meta.json",
            "model_final.meta.json", "model_best_loss.meta.json"} <= set(snaps)
    for f in snaps:
        with open(os.path.join(jdir, f)) as a, open(os.path.join(pdir, f)) as b:
            jm, pm = json.load(a), json.load(b)
        assert jm["epoch"] == pm["epoch"], f
        np.testing.assert_allclose([pm["best_loss"], pm["best_acc"]],
                                   [jm["best_loss"], jm["best_acc"]], rtol=1e-3, err_msg=f)
        assert os.path.isdir(os.path.join(pdir, f[:-len(".meta.json")]))
    with open(os.path.join(jdir, "metrics.jsonl")) as a, open(os.path.join(pdir,
                                                                         "metrics.jsonl")) as b:
        jtags = [(r["step"], sorted(r)) for r in map(json.loads, a)]
        ptags = [(r["step"], sorted(r)) for r in map(json.loads, b)]
    assert jtags == ptags and len(ptags) == 2

    m, lr = jcfg.momentum, jcfg.lr
    bound = lr * sum(m ** (k - j) * (5e-3 + 5e-3 * gmax[j]) for k in range(4) for j in range(k + 1))
    jparams = _np(jstate.params)
    for name, t in train_tensors(pt.state.model):
        np.testing.assert_allclose(t.detach().numpy(), jparams[name].numpy(), rtol=0, atol=bound,
                                   err_msg=name)
    assert int(jstate.step) == pt.state.step == 4
