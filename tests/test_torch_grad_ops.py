"""Port vs JAX: the activations whose gradients at exactly 0 differ
between the frameworks' stock versions. The port's leaky ReLU is
``where(x >= 0, x, 0.1 x)`` (gradient 1 at 0, as ``jax.nn.leaky_relu``;
``F.leaky_relu`` gives 0.1) and its softplus is ``logaddexp(x, 0)``
(gradient 0.5 at 0, as ``jax.nn.softplus``). At 0 values and gradients
equal JAX's exactly; at +-1 within one float32 ulp (softplus goes through
``exp``, which the two libraries round differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu_torch.models.blocks import leaky_relu
from d3feat_tpu_torch.models.kpfcnn import softplus

FNS = {"leaky_relu": (leaky_relu, lambda x: jax.nn.leaky_relu(x, 0.1)),
       "softplus": (softplus, jax.nn.softplus)}


@pytest.mark.parametrize("x0", [-1.0, 0.0, 1.0])
@pytest.mark.parametrize("name", sorted(FNS))
def test_value_and_grad_match_jax(name, x0):
    tfn, jfn = FNS[name]
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    y = tfn(x)
    (g,) = torch.autograd.grad(y, x)
    jy, jg = jax.value_and_grad(jfn)(jnp.float32(x0))
    rtol = 0.0 if x0 == 0.0 else float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(y.item(), float(jy), rtol=rtol, atol=0)
    np.testing.assert_allclose(g.item(), float(jg), rtol=rtol, atol=0)


def test_stock_torch_differs_at_zero():
    """What the repairs are for: the stock PyTorch gradients at 0."""
    x = torch.tensor(0.0, requires_grad=True)
    (g,) = torch.autograd.grad(torch.nn.functional.leaky_relu(x, 0.1), x)
    assert g.item() == pytest.approx(0.1)
    (g,) = torch.autograd.grad(torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs())), x)
    assert g.item() == 1.0
    assert float(jax.grad(jax.nn.softplus)(0.0)) == 0.5
