"""Port vs JAX: ``cdist`` (5 metrics), ``circle_loss``,
``contrastive_loss`` and ``det_loss`` on padded random inputs (as
``tests/test_losses.py`` builds them), values and autograd gradients
against ``jax.grad`` at rtol 1e-6 / atol 1e-6. The margin cases put
distances exactly on ``pos_margin`` / ``neg_margin`` (cityblock distances
of single-coordinate rows), where ``jnp.maximum`` splits the gradient, and
many coordinate differences exactly at 0, where JAX's ``|x|`` has gradient 1.

For 'cosine' and 'arccosine' the inputs are multiples of 1/8 below 1/4, so
every ``a . b`` is exact in float32: their gradients carry
``1 / sqrt(2 - 2 a.b)`` (resp. ``1 / sqrt(1 - c^2)``), which turns the
last-bit difference between the two libraries' dot products on general
inputs into a few 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.losses import circle_loss as j_circle, contrastive_loss as j_contrastive
from d3feat_tpu.losses import det_loss as j_det
from d3feat_tpu.losses.distances import cdist as j_cdist
from d3feat_tpu_torch.losses.descriptor import circle_loss, contrastive_loss
from d3feat_tpu_torch.losses.detector import det_loss
from d3feat_tpu_torch.losses.distances import cdist
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-6, atol=1e-6)
M, N_VALID, D = 20, 14, 8


def _inputs(seed, metric="euclidean"):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, D)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    p = a + 0.3 * rng.normal(size=(M, D)).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    a[N_VALID:] = 0.0
    p[N_VALID:] = 0.0
    keypts = rng.uniform(0, 0.4, size=(M, 3))
    dk = np.linalg.norm(keypts[:, None] - keypts[None], axis=-1).astype(np.float32)
    dk[N_VALID:, :] = 1.0e4
    dk[:, N_VALID:] = 1.0e4
    valid = np.arange(M) < N_VALID
    w = rng.normal(size=(M, M)).astype(np.float32)
    return a.astype(np.float32), p.astype(np.float32), dk, valid, w


MARGINS = dict(pos_margin=0.125, neg_margin=1.375)


def _margin_inputs():
    """Coordinates on a 1/16 grid (so every cityblock distance is exact)
    with margins on the same grid: many distances sit exactly on a margin
    and many coordinate differences are exactly 0."""
    rng = np.random.default_rng(9)
    a = np.zeros((M, D), np.float32)
    a[:, :2] = rng.integers(0, 48, size=(M, 2)) / 16
    p = a.copy()
    p[:, 0] += rng.choice([0.0, 0.0625, 0.125], size=M)
    keypts = rng.uniform(0, 1, size=(M, 3))
    dk = np.linalg.norm(keypts[:, None] - keypts[None], axis=-1).astype(np.float32)
    valid = np.arange(M) < N_VALID
    return a, p.astype(np.float32), dk, valid, None


def _grads_t(fn, a, p, *rest):
    ta = torch.tensor(a, requires_grad=True)
    tp = torch.tensor(p, requires_grad=True)
    out = fn(ta, tp, *rest)
    ga, gp = torch.autograd.grad(out, (ta, tp))
    return out.detach().numpy(), ga.numpy(), gp.numpy()


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cityblock", "cosine",
                                    "arccosine"])
def test_cdist_matches_jax(metric):
    a, p, _, _, w = _inputs(1)
    a, p = a[:N_VALID], p[:N_VALID]
    w = w[:N_VALID, :N_VALID]
    if metric in ("cosine", "arccosine"):
        rng = np.random.default_rng(4)
        a, p = (rng.integers(-2, 3, size=(N_VALID, D)).astype(np.float32) / 8 for _ in range(2))
    tw = torch.from_numpy(w)
    t_out, t_ga, t_gp = _grads_t(lambda x, y: (cdist(x, y, metric) * tw).sum(), a, p)
    t_val = cdist(torch.from_numpy(a), torch.from_numpy(p), metric).numpy()
    j_val = j_cdist(jnp.asarray(a), jnp.asarray(p), metric)
    j_out, (j_ga, j_gp) = jax.value_and_grad(
        lambda x, y: jnp.sum(j_cdist(x, y, metric) * w), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(p))
    np.testing.assert_allclose(t_val, np.asarray(j_val), **TOL)
    np.testing.assert_allclose(t_out, float(j_out), rtol=1e-5)
    np.testing.assert_allclose(t_ga, np.asarray(j_ga), **TOL)
    np.testing.assert_allclose(t_gp, np.asarray(j_gp), **TOL)


def _loss_case(kind, inputs, metric, **margins):
    a, p, dk, valid, _ = inputs
    tdk, tv = torch.from_numpy(dk), torch.from_numpy(valid)
    if kind == "circle":
        tfn = lambda x, y: circle_loss(x, y, tdk, tv, dist_type=metric, **margins)
        jfn = lambda x, y: j_circle(x, y, jnp.asarray(dk), jnp.asarray(valid), dist_type=metric,
                                    **margins)
    else:
        tfn = lambda x, y: contrastive_loss(x, y, tdk, tv, metric=metric, safe_radius=0.1,
                                            **margins)
        jfn = lambda x, y: j_contrastive(x, y, jnp.asarray(dk), jnp.asarray(valid),
                                         metric=metric, safe_radius=0.1, **margins)
    t_res = tfn(torch.from_numpy(a), torch.from_numpy(p))
    _, t_ga, t_gp = _grads_t(lambda x, y: tfn(x, y).loss, a, p)
    j_res = jfn(jnp.asarray(a), jnp.asarray(p))
    j_ga, j_gp = jax.grad(lambda x, y: jfn(x, y).loss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(p))
    for field in ("loss", "accuracy", "d_pos", "d_neg"):
        np.testing.assert_allclose(getattr(t_res, field).item(),
                                   float(getattr(j_res, field)), **TOL, err_msg=field)
    np.testing.assert_allclose(t_res.dists.numpy(), np.asarray(j_res.dists), **TOL)
    np.testing.assert_allclose(t_ga, np.asarray(j_ga), **TOL)
    np.testing.assert_allclose(t_gp, np.asarray(j_gp), **TOL)
    return t_res, t_ga


@pytest.mark.parametrize("kind", ["circle", "contrastive"])
@pytest.mark.parametrize("seed", [0, 1])
def test_desc_loss_matches_jax(kind, seed):
    _, ga = _loss_case(kind, _inputs(seed), "euclidean")
    assert np.abs(ga).max() > 1e-3  # the gradient comparison is not vacuous


@pytest.mark.parametrize("kind", ["circle", "contrastive"])
def test_desc_loss_ties_at_margins_match_jax(kind):
    res, _ = _loss_case(kind, _margin_inputs(), "cityblock", **MARGINS)
    d = res.dists.detach().numpy()[:N_VALID, :N_VALID]
    assert (np.diag(d) == MARGINS["pos_margin"]).any()     # positives on the margin
    assert (d == MARGINS["neg_margin"]).any()               # pairs on the negative margin


@pytest.mark.parametrize("seed", [0, 1])
def test_det_loss_matches_jax(seed):
    a, p, dk, valid, _ = _inputs(seed)
    rng = np.random.default_rng(seed + 5)
    sa = rng.uniform(0, 1, size=(M, 1)).astype(np.float32)
    sp = rng.uniform(0, 1, size=(M, 1)).astype(np.float32)
    d = np.array(j_cdist(jnp.asarray(a), jnp.asarray(p)))
    d[2, 5] = d[2, 2]  # a tie between a negative and the positive
    tv = torch.from_numpy(valid)
    td = torch.tensor(d, requires_grad=True)
    tsa = torch.tensor(sa, requires_grad=True)
    tsp = torch.tensor(sp, requires_grad=True)
    t_val = det_loss(td, tsa, tsp, tv)
    t_g = torch.autograd.grad(t_val, (td, tsa, tsp))
    j_val, j_g = jax.value_and_grad(lambda *x: j_det(*x, jnp.asarray(valid)), argnums=(0, 1, 2))(
        jnp.asarray(d), jnp.asarray(sa), jnp.asarray(sp))
    np.testing.assert_allclose(t_val.item(), float(j_val), **TOL)
    for tg, jg in zip(t_g, j_g):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
