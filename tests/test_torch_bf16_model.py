"""Port vs JAX with ``compute_dtype="bfloat16"`` (bf16 linear layers and
bf16 band-KPConv panels, the twins on the CPU, the JAX Pallas kernels in
interpret mode), 3 layers, the shared test pair, the same JAX-initialised
parameters:

- the forward on the same sorted pyramid (gate off): descriptors and
  scores within relative L2 1e-2 of JAX's bf16 forward (the JAX suite's
  bf16 bound, ``tests/test_band_conv.py:139-195``); descriptors within it
  of the port's f32 forward (the gated scores are not: bf16 rounding makes
  and breaks exact per-channel local maxima, in JAX as in the port). JAX
  runs op by op here: jitted, XLA keeps the bf16 products of the linear
  layers in f32 (excess precision), its gated scores then follow f32's,
  and they lie at relative L2 0.89 from the op-by-op program's, whose
  rounding the port reproduces;
- one train step from raw points against JAX's bf16 step, jitted in a
  subprocess with ``--xla_allow_excess_precision=false``: by default XLA
  keeps the bf16 products of the linear layers in f32, where JAX's program
  and the port round them (the flag is read once per process, so it cannot
  be set for one test in the test process). Loss at rtol 1e-2, none
  skipped; the gradient of every parameter within relative L2 1e-2 of
  JAX's, and the flat gradient nearer JAX's bf16 gradient than a tenth of
  the port's f32 gradient's distance to it (a step that did not round
  fails). JAX's gradients come from its first momentum trace
  (``g = trace - weight_decay * p``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.kpfcnn import apply_kpfcnn as j_apply, init_kpfcnn as j_init
from d3feat_tpu_torch.compat.weights import params_from_numpy
from d3feat_tpu_torch.models.kpfcnn import apply_kpfcnn, init_kpfcnn
from d3feat_tpu_torch.train.optim import make_optimizer, train_tensors
from d3feat_tpu_torch.train.step import TrainState, make_train_step
from tests.torch_port_helpers import jax_config, jax_pyramid, pair_batch, \
    torch_batch_from_jax, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

BOUND = 1e-2
LAYERS = 3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_forward_bf16_matches_jax():
    _, (_, feats, _), pyr = jax_pyramid(3, LAYERS)
    jcfg = jax_config(LAYERS, eval_gate_topm=0)
    params, state, specs = j_init(jax.random.key(2), jcfg)
    feats_sorted = feats[pyr["band"][0]["order"]]
    jbatch = jax.tree.map(jnp.asarray, dict(pyr, features=feats_sorted))
    jout, _, _ = j_apply(params, state, jbatch, jcfg, specs, train=False, per_cloud_norm=True,
                         compute_dtype=jnp.bfloat16)
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    model.load_state_dict(params_from_numpy(jax.tree.map(np.asarray, params)))
    batch = torch_batch_from_jax(pyr, feats_sorted)
    tout = apply_kpfcnn(model, batch, per_cloud_norm=True, compute_dtype=torch.bfloat16)
    f32 = apply_kpfcnn(model, batch, per_cloud_norm=True)
    for name in ("features", "scores"):
        got, want = getattr(tout, name).numpy(), np.asarray(getattr(jout, name))
        assert rel_l2(got, want) < BOUND, (name, rel_l2(got, want))
    assert rel_l2(tout.features.numpy(), f32.features.numpy()) < BOUND
    assert not np.array_equal(tout.features.numpy(), f32.features.numpy())
    assert (np.asarray(jout.scores) > 0).sum() > 50


_JAX_STEP = """
import sys

import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from d3feat_tpu.train import init_train_state, make_train_step
from d3feat_tpu_torch.compat.weights import params_from_numpy
from tests.torch_port_helpers import jax_band_spec, jax_config, pair_batch

jcfg = jax_config(int(sys.argv[2]), compute_dtype="bfloat16")
ts, specs = init_train_state(jax.random.key(0), jcfg)
step = jax.jit(make_train_step(jcfg, specs, pyramid_spec=jax_band_spec(jcfg)))
ts2, m = step(ts, {k: jnp.asarray(v) for k, v in pair_batch(3).items()}, jnp.int32(0))
leaves = {"p." + k: v.numpy() for k, v in
          params_from_numpy(jax.tree.map(np.asarray, ts.params)).items()}
leaves.update({"t." + k: v.numpy() for k, v in params_from_numpy(
    jax.tree.map(np.asarray, ts2.opt_state[-1].trace)).items()})
np.savez(sys.argv[1], loss=float(m.loss), skipped=float(m.skipped), **leaves)
"""


@pytest.fixture(scope="module")
def jax_bf16_step(tmp_path_factory):
    """(loss, skipped, initial parameters, gradients) of JAX's bf16 train
    step, run where XLA rounds every bf16 product (module docstring)."""
    out = tmp_path_factory.mktemp("jax_bf16_step") / "step.npz"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", _JAX_STEP, str(out), str(LAYERS)], cwd=root, env=env,
                   check=True, timeout=900)
    z = np.load(out)
    wd = jax_config(LAYERS).weight_decay
    params = {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("p.")}
    grads = {n: z["t." + n] - wd * p.numpy() for n, p in params.items()}
    return float(z["loss"]), float(z["skipped"]), params, grads


def test_train_step_bf16_matches_jax(jax_bf16_step):
    jloss, jskipped, params, jgrads = jax_bf16_step
    jcfg = jax_config(LAYERS, compute_dtype="bfloat16")
    b = pair_batch(3)
    grads, metrics = {}, {}
    for dt in ("bfloat16", "float32"):
        tcfg = torch_config(jcfg)
        tcfg.compute_dtype = dt
        model = init_kpfcnn(tcfg, device="cpu")
        model.load_state_dict(params)
        state = TrainState(model, make_optimizer(tcfg, model))
        state, metrics[dt] = make_train_step(tcfg)(
            state, {k: torch.from_numpy(np.array(v, copy=True)) for k, v in b.items()}, 0)
        grads[dt] = {n: t.grad.numpy() for n, t in train_tensors(model)}
    tm = metrics["bfloat16"]
    assert tm.skipped == jskipped == 0.0 and tm.overflow == 0.0
    np.testing.assert_allclose(tm.loss, jloss, rtol=BOUND)
    assert tm.loss != metrics["float32"].loss
    names = sorted(grads["float32"])
    assert sorted(jgrads) == names
    for n in names:
        if np.linalg.norm(jgrads[n]) > 0.0:
            assert rel_l2(grads["bfloat16"][n], jgrads[n]) < BOUND, (
                n, rel_l2(grads["bfloat16"][n], jgrads[n]))
    jg, tg, fg = (np.concatenate([g[n].ravel() for n in names])
                  for g in (jgrads, grads["bfloat16"], grads["float32"]))
    assert np.isfinite(tg).all()
    assert rel_l2(tg, jg) < BOUND and rel_l2(tg, jg) < 0.1 * rel_l2(fg, jg), (
        rel_l2(tg, jg), rel_l2(fg, jg))
