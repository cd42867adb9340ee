"""Port vs JAX: the kernel-point generators and loader
(``models/kernel_points.py``), bit for bit on the same seeds.

Both packages' generators are numpy code. The uncommitted dispositions are
small (K 5 runs the repulsion optimiser, K 31 Lloyd's algorithm); JAX's
loader gets a temporary ``cache_dir`` so that nothing is written into its
package. ``init_kpfcnn`` with ``deterministic_kernel_points=False`` gives
every conv the same kernel points in both packages."""

import os

import jax
import numpy as np
import pytest

from d3feat_tpu.models import kernel_points as J
from d3feat_tpu_torch.models import kernel_points as P
from tests.torch_port_helpers import jax_config, torch_config
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

SMALL_K = (5, 31)  # repulsion (K <= 30) and Lloyd (K > 30)


def test_rotation_and_fixed_points_match_jax():
    for axis, angle in (([0.0, 0.0, 1.0], 0.3), ([1.0, 2.0, -0.5], 2.1)):
        np.testing.assert_array_equal(P.rotation_from_axis_angle(axis, angle),
                                      J.rotation_from_axis_angle(axis, angle))
    for seed in (0, 1):
        a = P._init_in_ball(np.random.default_rng(seed), 40, 3, 0.7)
        b = J._init_in_ball(np.random.default_rng(seed), 40, 3, 0.7)
        np.testing.assert_array_equal(a, b)
        for fixed in ("center", "verticals", "none"):
            np.testing.assert_array_equal(P._apply_fixed(a.reshape(2, 20, 3).copy(), fixed),
                                          J._apply_fixed(b.reshape(2, 20, 3).copy(), fixed))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("fixed", ["center", "verticals"])
def test_optimisers_match_jax(seed, fixed):
    """Both optimisers cut short (few candidates and iterations)."""
    kp, norms = P.optimize_repulsion(6, fixed=fixed, num_candidates=8, max_iter=300, seed=seed)
    jkp, jnorms = J.optimize_repulsion(6, fixed=fixed, num_candidates=8, max_iter=300,
                                       seed=seed)
    np.testing.assert_array_equal(kp, jkp)
    np.testing.assert_array_equal(norms, jnorms)
    np.testing.assert_array_equal(
        P.lloyd_sphere(33, fixed=fixed, approx_n=600, max_iter=25, seed=seed),
        J.lloyd_sphere(33, fixed=fixed, approx_n=600, max_iter=25, seed=seed))


@pytest.mark.parametrize("k", SMALL_K)
@pytest.mark.parametrize("seed", [7])  # the loader's seed 42 in test_randomised_load_matches_jax
def test_generate_kernel_points_matches_jax(k, seed):
    np.testing.assert_array_equal(P.generate_kernel_points(k, seed=seed),
                                  J.generate_kernel_points(k, seed=seed))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """(port cache, JAX cache): each generates the small dispositions once."""
    return (str(tmp_path_factory.mktemp("port_kp")), str(tmp_path_factory.mktemp("jax_kp")))


@pytest.mark.parametrize("k", SMALL_K)
@pytest.mark.parametrize("seed", [0, 1, 2, 1234])
def test_randomised_load_matches_jax(caches, k, seed):
    port_dir, jax_dir = caches
    a = P.load_kernels(0.25, k, deterministic=False, seed=seed, cache_dir=port_dir)
    b = J.load_kernels(0.25, k, deterministic=False, seed=seed, cache_dir=jax_dir)
    assert a.dtype == np.float32 and a.shape == (k, 3)
    np.testing.assert_array_equal(a, b)
    # the generated disposition was cached where asked, and is read back
    cached = os.path.join(port_dir, f"k_{k:03d}_center_3D.npy")
    np.testing.assert_array_equal(np.load(cached), np.load(os.path.join(
        jax_dir, f"k_{k:03d}_center_3D.npy")))
    np.testing.assert_array_equal(
        P.load_kernels(0.25, k, cache_dir=port_dir),
        J.load_kernels(0.25, k, cache_dir=jax_dir))


def test_committed_disposition_and_default_cache():
    """K 15 is read from the port's committed copy, equal to JAX's; the
    default cache for generated ones is the git-ignored build directory."""
    for det, seed in ((True, None), (False, 5)):
        np.testing.assert_array_equal(P.load_kernels(0.3, 15, deterministic=det, seed=seed),
                                      J.load_kernels(0.3, 15, deterministic=det, seed=seed))
    pkg = os.path.dirname(os.path.dirname(P.__file__))
    assert os.path.commonpath([P._CACHE_DIR, os.path.join(pkg, "_build")]) == \
        os.path.join(pkg, "_build")


@pytest.mark.parametrize("seed", [0, 9])
def test_init_kpfcnn_randomised_kernel_points_match_jax(seed):
    from d3feat_tpu.models.kpfcnn import init_kpfcnn as j_init
    from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn

    jcfg = jax_config(3, deterministic_kernel_points=False, seed=seed)
    params, _, _ = j_init(jax.random.key(0), jcfg)
    model = init_kpfcnn(torch_config(jcfg), device="cpu")
    n = 0
    for part in ("encoder", "decoder"):
        for jp, blk in zip(params[part], getattr(model, part)):
            if hasattr(blk, "conv"):
                np.testing.assert_array_equal(blk.conv.kernel_points.numpy(),
                                              np.asarray(jp["conv"].kernel_points))
                n += 1
    assert n == 8
    det = init_kpfcnn(torch_config(jax_config(3)), device="cpu")
    assert not np.array_equal(det.encoder[0].conv.kernel_points.numpy(),
                              model.encoder[0].conv.kernel_points.numpy())
