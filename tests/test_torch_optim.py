"""Port vs JAX: the learning-rate schedule bit for bit, and SGD/Adam steps
(with and without the global-norm clip) against the optax chain of
``d3feat_tpu.train.optim`` at atol 2e-6 (``tests/test_optim_parity.py``).
The parameters include a KPConv kernel-point buffer, which JAX keeps in
its parameter tree: a zero gradient, but decayed and traced, as the port's
optimizer treats it (lr 0.05, weight decay 1e-2 so that it shows).

Under Adam the kernel points' gradient is the weight decay alone, of one
sign, so every step moves them by about the full lr; there optax's
bias corrections ``1 - beta^t``, which it computes in float32 (1 - 0.999
rounds to 0.00099998713, 1.3e-5 relative), and ``torch.optim.Adam``'s, in
float64, part by that rounding times the lr on each step. Those are
compared within 2e-6 plus that rounding, computed here."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3feat_tpu.config import D3FeatConfig as JConfig
from d3feat_tpu.train.optim import learning_rate as j_lr, make_optimizer as j_opt
from d3feat_tpu_torch.config import D3FeatConfig
from d3feat_tpu_torch.train.optim import learning_rate, make_optimizer, optimizer_step


@pytest.mark.parametrize("epoch", [0, 1, 79, 80, 200])
def test_learning_rate_bit_exact(epoch):
    jcfg = JConfig()
    tcfg = D3FeatConfig.from_dict(jcfg.to_dict())
    assert np.float32(learning_rate(tcfg, epoch)) == np.asarray(j_lr(jcfg, epoch))


def _bias_rounding(lr, steps, b1=0.9, b2=0.999):
    """Sum over the steps of lr x the relative difference between Adam's
    step computed with float32 and with float64 bias corrections."""
    out = 0.0
    for t in range(1, steps + 1):
        c1 = float(np.float32(1) - np.float32(b1) ** np.int32(t)) / (1 - b1**t)
        c2 = float(np.float32(1) - np.float32(b2) ** np.int32(t)) / (1 - b2**t)
        out += lr * (abs(c1 - 1) + abs(np.sqrt(c2) - 1))
    return out


class _Tiny(torch.nn.Module):
    def __init__(self, w0, kp0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        self.conv = torch.nn.Module()
        self.conv.register_buffer("kernel_points", torch.from_numpy(kp0.copy()))


@pytest.mark.parametrize("clip", [0.0, 2.0])
@pytest.mark.parametrize("name", ["SGD", "ADAM"])
def test_steps_match_optax(name, clip):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    kp0 = rng.normal(size=(15, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(6)]
    jcfg = JConfig()
    jcfg.optimizer, jcfg.lr, jcfg.weight_decay, jcfg.momentum = name, 0.05, 1e-2, 0.98
    jcfg.grad_clip_norm = clip
    tcfg = D3FeatConfig.from_dict(jcfg.to_dict())

    tx = j_opt(jcfg)
    params = {"w": jnp.asarray(w0), "kp": jnp.asarray(kp0)}
    state = tx.init(params)
    lr = j_lr(jcfg, 0)
    for g in grads:
        upd, state = tx.update({"w": jnp.asarray(g), "kp": jnp.zeros_like(params["kp"])},
                               state, params)
        params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, upd))

    model = _Tiny(w0, kp0)
    opt = make_optimizer(tcfg, model)
    for g in grads:
        opt.zero_grad(set_to_none=True)
        model.w.grad = torch.from_numpy(g.copy())
        optimizer_step(tcfg, opt, model, learning_rate(tcfg, 0))

    np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(params["w"]), atol=2e-6)
    kp = model.conv.kernel_points.numpy()
    np.testing.assert_allclose(kp, np.asarray(params["kp"]), atol=2e-6 + _bias_rounding(
        tcfg.lr, len(grads)) if name == "ADAM" else 2e-6)
    assert np.abs(kp - kp0).max() > 1e-3  # the kernel points did move
    if clip:
        norms = [np.linalg.norm(g) for g in grads]
        assert max(norms) > clip  # the clip did act
