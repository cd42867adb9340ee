"""Data parallelism on ``torch.distributed``: two gloo ranks on the CPU,
each its own process with one torch thread, joined on a ``file://`` store
in ``tmp_path``, against the single-process port and JAX's
``make_dp_train_step`` on a 2-device mesh (``tests/conftest.py`` gives 8
CPU devices), 3 layers at the shapes of ``torch_port_helpers``.

One module fixture runs the ranks once (each scenario in turn, a 120 s
group timeout, a 600 s wall limit) and every test reads its part:

(a) the same pair on both ranks: the step equals the single-process step
    bit for bit (metrics, updated weights, momentum): ``(g + g) / 2 == g``
    (the counterpart of ``tests/test_train_step.py:117-139``);
(b) two different pairs: loss and metrics, and the averaged gradients,
    against JAX's ``make_dp_train_step`` at ``test_torch_train_step.py``'s
    (b) tolerances (loss rtol 1e-3, gradients atol 5e-3 / rtol 5e-3);
    both ranks hold the same weights after it;
(c) extraction: every rank holds both ranks' outputs, equal bit for bit to
    two single extractions; evaluation: the metrics are the ranks' mean;
(d) a NaN feature on rank 1 only: both ranks skip, weights unchanged;
(e) batch norm with two ranks raises;
(f) ``Trainer(num_devices=2)``: after 2 steps both ranks hold the same
    weights, and only rank 0 wrote snapshots, ``config.json`` and the
    metrics log;
(g) ``python3 -m d3feat_tpu_torch.parallel.dryrun 2`` at full depth: its
    averaged gradients equal the mean of the two single steps', and its
    gathered extraction the single extractions."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import CAPS, jax_band_spec, jax_config, pair_batch, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

LAYERS = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_S = 600
FIELDS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg", "lr", "skipped",
          "overflow")


def _tensors(b):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in b.items()}


def _state(tcfg, weights):
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.train.optim import make_optimizer
    from d3feat_tpu_torch.train.step import TrainState

    model = init_kpfcnn(tcfg, device="cpu")
    model.load_state_dict(weights)
    return TrainState(model, make_optimizer(tcfg, model))


def _snapshot(state):
    from d3feat_tpu_torch.compat.weights import optimizer_state_by_name
    from d3feat_tpu_torch.train.optim import train_tensors

    return ({n: t.detach().clone() for n, t in train_tensors(state.model)},
            {n: v.clone() for n, v in optimizer_state_by_name(
                state.model, state.optimizer)["momentum_buffer"].items()})


def _rank_main(rank, world, work):
    """One rank of the fixture's job: every scenario in turn, results into
    ``work/rank<rank>.pt``."""
    import torch.distributed as dist

    from d3feat_tpu_torch.data.loader import PairLoader
    from d3feat_tpu_torch.data.synthetic import SyntheticPairDataset
    from d3feat_tpu_torch.parallel import init_group, make_dp_eval_step, \
        make_dp_extract_step, make_dp_train_step, shard_batch, stack_batches
    from d3feat_tpu_torch.train.optim import train_tensors
    from d3feat_tpu_torch.train.trainer import Trainer

    init_group("cpu", world_size=world, rank=rank, init_method=f"file://{work}/store",
               timeout_s=120)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    tcfg, out = inp["config"], {}
    pairs = inp["pairs"]
    mine = lambda stacked: shard_batch(stacked, rank, "cpu", world)  # noqa: E731

    state = _state(tcfg, inp["weights"])
    step = make_dp_train_step(tcfg)
    _, m = step(state, mine(stack_batches([pairs[0], pairs[0]])), 0)
    out["same"] = (m._asdict(), *_snapshot(state))

    state = _state(tcfg, inp["weights"])
    _, m = step(state, mine(stack_batches(pairs)), 0)
    grads = {n: t.grad.clone() for n, t in train_tensors(state.model)}
    out["diff"] = (m._asdict(), grads, _snapshot(state)[0])

    model = state.model
    stacked = stack_batches(pairs)
    extract = make_dp_extract_step(tcfg)
    out["extract"] = extract(model, {k: v for k, v in mine(stacked).items()
                                     if k in ("points", "features", "lengths")})
    out["eval"] = make_dp_eval_step(tcfg)(model, mine(stacked))._asdict()

    bad = [dict(p) for p in pairs]
    bad[1]["features"] = bad[1]["features"].copy()
    bad[1]["features"][0, 0] = np.nan
    before = _snapshot(state)
    _, m = step(state, mine(stack_batches(bad)), 0)
    after = _snapshot(state)
    out["nan"] = (m.skipped, all(torch.equal(before[0][n], after[0][n]) for n in before[0]),
                  state.step)

    try:
        make_dp_train_step(inp["bn_config"])
        out["bn"] = None
    except NotImplementedError as e:
        out["bn"] = str(e)

    cfg = inp["config"]
    cfg.num_devices, cfg.max_epoch, cfg.training_max_iter = world, 1, 2
    cfg.snapshot_interval, cfg.verbose = 1, False
    cfg.snapshot_root, cfg.experiment_id = os.path.join(work, f"rank{rank}"), "run"
    ds = SyntheticPairDataset(size=4, n_points=220, num_corr=8, seed=0)
    tr = Trainer(cfg, PairLoader(ds, point_capacity=CAPS[0], corr_capacity=8,
                                 num_devices=world, num_workers=2, seed=0), None,
                 device="cpu")
    tr.train()
    out["trainer"] = (_snapshot(tr.state)[0], tr.state.step)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _spawn(world, work):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    code = ("import sys; from tests.test_torch_data_parallel import _rank_main; "
            "_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(work)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=WALL_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{log[-4000:]}"
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(config, JAX train state, the two pairs, each rank's results)."""
    import jax

    from d3feat_tpu.train import init_train_state
    from d3feat_tpu_torch.compat.weights import params_from_numpy

    jcfg = jax_config(LAYERS)
    ts, _ = init_train_state(jax.random.key(0), jcfg)
    weights = params_from_numpy(jax.tree.map(np.asarray, ts.params))
    pairs = [pair_batch(3), pair_batch(5)]
    work = tmp_path_factory.mktemp("dp")
    torch.save({"config": torch_config(jcfg), "weights": weights, "pairs": pairs,
                "bn_config": torch_config(jax_config(LAYERS, use_batch_norm=True))},
               os.path.join(work, "inputs.pt"))
    return jcfg, ts, weights, pairs, _spawn(2, work), work


def test_replicated_pair_equals_single_step_bit_for_bit(ranks):
    from d3feat_tpu_torch.train.step import make_train_step

    jcfg, _, weights, pairs, res, _ = ranks
    tcfg = torch_config(jcfg)
    state = _state(tcfg, weights)
    _, m = make_train_step(tcfg)(state, _tensors(pairs[0]), 0)
    params, momentum = _snapshot(state)
    for r in res:
        got, gparams, gmomentum = r["same"]
        assert got == m._asdict()
        assert all(torch.equal(gparams[n], params[n]) for n in params)
        assert all(torch.equal(gmomentum[n], momentum[n]) for n in momentum)


def test_two_pairs_match_jax_dp_step(ranks):
    import jax
    import jax.numpy as jnp

    from d3feat_tpu.parallel import make_dp_train_step as j_make_dp, make_mesh, \
        stack_shard_batch
    from d3feat_tpu_torch.compat.weights import params_from_numpy

    jcfg, ts, _, pairs, res, _ = ranks
    mesh = make_mesh(2)
    step = j_make_dp(jcfg, mesh, pyramid_spec=jax_band_spec(jcfg))
    ts2, jm = step(ts, stack_shard_batch(pairs, mesh), jnp.int32(0))
    np_ = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree))  # noqa: E731
    trace, params = np_(ts2.opt_state[-1].trace), np_(ts.params)
    jgrads = {k: trace[k] - jcfg.weight_decay * params[k] for k in trace}
    (m0, g0, p0), (m1, g1, p1) = res[0]["diff"], res[1]["diff"]
    assert m0 == m1 and all(torch.equal(p0[n], p1[n]) for n in p0)
    assert m0["skipped"] == float(jm.skipped) == 0.0
    assert m0["overflow"] == float(jm.overflow) == 0.0
    np.testing.assert_allclose(m0["loss"], float(jm.loss), rtol=1e-3)
    names = sorted(g0)
    assert names == sorted(jgrads)
    flat = np.concatenate([g0[n].numpy().ravel() for n in names])
    flat_j = np.concatenate([jgrads[n].numpy().ravel() for n in names])
    np.testing.assert_allclose(flat, flat_j, atol=5e-3, rtol=5e-3)
    assert np.abs(flat_j).max() > 1e-2


def test_extract_gathers_both_ranks_and_eval_averages(ranks):
    from d3feat_tpu_torch.train.optim import train_tensors
    from d3feat_tpu_torch.train.step import make_eval_step, make_extract_step

    jcfg, _, weights, pairs, res, _ = ranks
    tcfg = torch_config(jcfg)
    state = _state(tcfg, weights)
    extract = make_extract_step(tcfg)
    # the ranks extracted after their step on the two pairs: with the weights of (b)
    p0 = res[0]["diff"][2]
    with torch.no_grad():
        for n, t in train_tensors(state.model):
            t.copy_(p0[n])
    singles = [extract(state.model, {k: v for k, v in _tensors(p).items()
                                     if k in ("points", "features", "lengths")})
               for p in pairs]
    evals = [make_eval_step(tcfg)(state.model, _tensors(p)) for p in pairs]
    for r in res:
        feats, scores, overflow = r["extract"]
        assert feats.shape[0] == scores.shape[0] == overflow.shape[0] == 2
        for i, (f, s, o) in enumerate(singles):
            assert torch.equal(feats[i], f) and torch.equal(scores[i], s)
            assert bool(overflow[i]) == bool(o)
        for f in FIELDS:
            want = np.float32((np.float32(getattr(evals[0], f)) + np.float32(
                getattr(evals[1], f))) / np.float32(2))
            if f == "overflow":
                want = max(evals[0].overflow, evals[1].overflow)
            np.testing.assert_allclose(r["eval"][f], want, rtol=1e-6, err_msg=f)


def test_nonfinite_gradient_on_one_rank_skips_both(ranks):
    res = ranks[4]
    for r in res:
        skipped, unchanged, step = r["nan"]
        assert skipped == 1.0 and unchanged and step == 1


def test_batch_norm_with_two_ranks_raises(ranks):
    for r in ranks[4]:
        assert r["bn"] is not None and "batch-norm" in r["bn"]


def test_trainer_two_ranks_same_weights_rank0_writes(ranks):
    res, work = ranks[4], ranks[5]
    (p0, s0), (p1, s1) = res[0]["trainer"], res[1]["trainer"]
    assert s0 == s1 == 2
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    run0, run1 = os.path.join(work, "rank0", "run"), os.path.join(work, "rank1", "run")
    written = set(os.listdir(run0))
    assert {"config.json", "metrics.jsonl", "snapshot_epoch_1", "model_final"} <= written
    assert not os.path.exists(run1) or os.listdir(run1) == []


def test_dryrun_two_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "d3feat_tpu_torch.parallel.dryrun", "2"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=WALL_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "dryrun(2): loss=" in out.stdout and "skipped=0.0 step=1" in out.stdout
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    # gloo with two ranks sums g0 + g1 as the single-process reference does
    assert summary["grad_rel_l2_vs_singles"] == 0.0 and summary["extract_bitwise"]
