"""Port vs JAX: the gather KPConv (``models.kpconv.kpconv``, the reference's
``_rigid_core``), the rigid KPConv of every block the band kernels do not
cover.

(a) every ``KP_influence`` (constant, linear, gaussian) with ``sum`` and
    ``closest`` aggregation, f32 and bf16, against JAX's ``kpconv``:
    outputs at atol 3e-5 / rtol 1e-4 (``tests/test_band_conv.py``'s
    band-vs-gather bound) and the gradients in the features and the
    weights for a seeded cotangent against ``jax.grad`` at atol 5e-4 /
    rtol 1e-3. JAX runs op by op, so its bf16 products round where the
    port's do (``tests/test_torch_bf16_model.py``). ``closest`` takes an
    argmin over the kernel points: the inputs hold no near-tie (neighbours
    whose two nearest kernel points lie within 1e-3 of each other in d2 are
    made shadow), where the two stacks could pick different points;
(b) on the port's own band pyramid (3 layers), every conv of the model
    through the gather KPConv against the K2 twin on the same sorted lists
    and windows, and its autograd gradients against the K4 twin's."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu_torch.models.kernel_points import load_kernels
from d3feat_tpu_torch.models.kpconv import kpconv
from tests.torch_port_helpers import jax_config, packed_pair, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

JK = importlib.import_module("d3feat_tpu.models.kpconv")

S, Q, NN, CIN, COUT, EXTENT = 220, 160, 14, 8, 16, 0.3


def _inputs(aggregation):
    rng = np.random.default_rng(7)
    s = rng.uniform(0, 1, size=(S, 3)).astype(np.float32) * np.float32(0.6)
    q = s[:Q] + rng.normal(0, 0.01, size=(Q, 3)).astype(np.float32)
    d2 = ((q[:, None, :] - s[None, :, :]) ** 2).sum(-1)
    inds = np.argsort(d2, axis=1)[:, :NN].astype(np.int32)
    inds[rng.random((Q, NN)) < 0.15] = S  # shadow slots
    kp = load_kernels(EXTENT * 0.8, 15, dimension=3, fixed="center")
    if aggregation == "closest":  # no near-ties of the argmin (module docstring)
        nb = np.concatenate([s, np.full((1, 3), 1e6, np.float32)])[inds] - q[:, None, :]
        kd = np.sort(((nb[:, :, None, :].astype(np.float64) - kp) ** 2).sum(-1), axis=-1)
        inds[(kd[..., 1] - kd[..., 0]) < 1e-3] = S
    x = rng.standard_normal((S, CIN)).astype(np.float32)
    x[rng.random(S) < 0.2] = 0.0
    x[rng.random(S) < 0.1] *= -1.0
    w = (rng.standard_normal((15, CIN, COUT)) * 0.2).astype(np.float32)
    ct = rng.standard_normal((Q, COUT)).astype(np.float32)
    return q, s, inds, x, w, kp, ct


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aggregation", ["sum", "closest"])
@pytest.mark.parametrize("influence", ["constant", "linear", "gaussian"])
def test_gather_kpconv_matches_jax(influence, aggregation, dtype):
    q, s, inds, x, w, kp, ct = _inputs(aggregation)
    kw = dict(KP_extent=EXTENT, KP_influence=influence, aggregation_mode=aggregation)

    def jf(x_, w_):
        return JK.kpconv(jnp.asarray(q), jnp.asarray(s), jnp.asarray(inds), x_,
                         JK.KPConvParams(w_, jnp.asarray(kp)),
                         compute_dtype=getattr(jnp, dtype), **kw)[0]

    jout = np.asarray(jf(jnp.asarray(x), jnp.asarray(w)))
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(jf(a, b) * ct), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = kpconv(torch.tensor(q), torch.tensor(s), torch.tensor(inds), tx, tw, torch.tensor(kp),
                 compute_dtype=getattr(torch, dtype), **kw)
    assert out.dtype == torch.float32 and out.shape == (Q, COUT)
    (out * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=5e-4, rtol=1e-3)
    assert np.abs(jout).max() > 1e-2 and np.abs(np.asarray(jgx)).max() > 1e-2


@pytest.fixture(scope="module")
def band_setup():
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
    from d3feat_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    tcfg = torch_config(jax_config(3))
    pts, _, lens = packed_pair(3)
    batch = build_pyramid(torch.from_numpy(pts), torch.from_numpy(lens),
                          spec=make_pyramid_spec(tcfg), impl="plain")
    model = init_kpfcnn(tcfg, seed=1, device="cpu")
    blocks = [b for b in list(model.encoder) + list(model.decoder) if hasattr(b, "conv")]
    return tcfg, batch, blocks


def test_gather_kpconv_matches_band_twins_on_sorted_lists(band_setup):
    from d3feat_tpu_torch.models.blocks import (apply_band_kpconv, apply_gather_kpconv,
                                                band_conv_eligible)

    tcfg, batch, blocks = band_setup
    gen = torch.Generator().manual_seed(11)
    assert len(blocks) == 8  # simple, resnetb, then (strided, resnetb, resnetb) x 2
    for block in blocks:
        spec = block.spec
        assert band_conv_eligible(spec, batch, tcfg)
        cin = block.conv.weights.shape[1]
        n_rows = batch["points"][spec.layer].shape[0]
        n_q = batch["points"][spec.layer + 1 if spec.strided else spec.layer].shape[0]
        x = torch.randn((n_rows, cin), generator=gen) * batch["masks"][spec.layer][:, None]
        ct = torch.randn((n_q, block.conv.weights.shape[2]), generator=gen)
        outs, grads = [], []
        for fn in (lambda a: apply_band_kpconv(block.conv, spec, a, batch, tcfg, impl="plain"),
                   lambda a: apply_gather_kpconv(block.conv, spec, a, batch, tcfg)):
            xa = x.clone().requires_grad_(True)
            block.conv.weights.grad = None
            out = fn(xa)
            (out * ct).sum().backward()
            outs.append(out.detach())
            grads.append((xa.grad, block.conv.weights.grad.clone()))
        torch.testing.assert_close(outs[1], outs[0], atol=3e-5, rtol=1e-4)
        torch.testing.assert_close(grads[1][0], grads[0][0], atol=5e-4, rtol=1e-3)
        torch.testing.assert_close(grads[1][1], grads[0][1], atol=5e-4, rtol=1e-3)
        assert float(outs[0].abs().max()) > 1e-3, spec.name
