"""Port vs JAX: the augmentation draws, the warp field, the held-out scene
generator (``tools/ab_recall.py::make_scene``) and the scene cache
(``tools/scene_cache.py``), bit for bit on the same generator states."""

import importlib.util
import os
import sys

import numpy as np
import pytest

import d3feat_tpu.data.augment as j_aug
import d3feat_tpu.data.synthetic as j_syn
import d3feat_tpu_torch.data.augment as t_aug
import d3feat_tpu_torch.data.synthetic as t_syn
from d3feat_tpu_torch.eval import scene_cache as t_cache
from tests.torch_port_helpers import EVAL_CACHE, ROOT
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)


def _tool(name):
    """A module of ``tools/`` (which put ``tools/`` on ``sys.path`` for
    their own imports)."""
    if name not in sys.modules:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools",
                                                                          f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_draws_match_jax(seed):
    for fn, args in (("random_rotation", (1,)), ("random_rotation", (0, 0.5)),
                     ("random_so3", ()), ("random_translation", (0.3,))):
        ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
        _same([getattr(t_aug, fn)(ga, *args) for _ in range(3)],
              [getattr(j_aug, fn)(gb, *args) for _ in range(3)])
        assert ga.bit_generator.state == gb.bit_generator.state
    so3 = t_aug.random_so3(np.random.default_rng(seed))
    assert np.isclose(np.linalg.det(so3), 1.0)
    rng = np.random.default_rng(100 + seed)
    src, tgt = rng.normal(size=(50, 3)), rng.normal(size=(60, 3))
    for kw in ({}, {"augment_axis": 0, "augment_noise": 0.01, "augment_translation": 1.0}):
        _same(t_aug.augment_pair(np.random.default_rng(seed), src, tgt, **kw),
              j_aug.augment_pair(np.random.default_rng(seed), src, tgt, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_field_matches_jax(seed):
    x = np.random.default_rng(50 + seed).uniform(-2, 2, size=(300, 3))
    for amp in (1.0, 2.0):
        ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(t_syn.make_warp_field(ga, amp)(x), j_syn.make_warp_field(gb, amp)(x))
        assert ga.bit_generator.state == gb.bit_generator.state
    _same(t_syn.synthetic_fragment(np.random.default_rng(seed), 500, extent=2.0),
          j_syn.synthetic_fragment(np.random.default_rng(seed), 500, extent=2.0))


@pytest.mark.parametrize("seed,frame,warp", [(0, "axis", 2.0), (1, "so3", 2.0),
                                             (3, "axis", 0.0)])
def test_make_scene_matches_ab_recall(seed, frame, warp):
    ga, gb = np.random.default_rng(seed), np.random.default_rng(seed)
    a = t_cache.make_scene(ga, 5, (40, 30), frame=frame, warp=warp)
    b = _tool("ab_recall").make_scene(gb, 5, (40, 30), frame=frame, warp=warp)
    _same(a, b)
    assert ga.bit_generator.state == gb.bit_generator.state
    assert len(a[1]) > 0 and all(len(f) >= 2000 for f in a[0])


def test_scene_cache_matches_tool(tmp_path):
    tool = _tool("scene_cache")
    args = (424245, 12, "axis", 2.0)
    path = t_cache.cache_path(EVAL_CACHE, *args)
    assert path == tool.cache_path(EVAL_CACHE, *args) and os.path.exists(path)
    frags, poses = t_cache.load_scene(path)
    _same((frags, poses), tool.load_scene(path))
    assert len(frags) == 12 and len(poses) == 11
    _same((frags, poses), t_cache.get_scene(*args, cache_dir=EVAL_CACHE))
    # written by the port, read by the tool, and the reverse
    for writer, reader in ((t_cache, tool), (tool, t_cache)):
        out = str(tmp_path / f"{writer.__name__.split('.')[-1]}.npz")
        writer.save_scene(out, frags[:3], {k: poses[k] for k in list(poses)[:2]})
        _same(reader.load_scene(out), (frags[:3], {k: poses[k] for k in list(poses)[:2]}))


def test_get_scene_generates_and_caches(tmp_path):
    a = t_cache.get_scene(7, 3, "axis", 1.0, resolution=(40, 30), cache_dir=str(tmp_path))
    path = t_cache.cache_path(str(tmp_path), 7, 3, "axis", 1.0)
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    frags, poses, _ = _tool("ab_recall").make_scene(np.random.default_rng(7), 3, (40, 30),
                                                    frame="axis", warp=1.0)
    _same(a, (frags, poses))
    _same(t_cache.load_scene(path), (frags, poses))
