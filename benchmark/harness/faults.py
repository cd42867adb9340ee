"""Faults planted in the timed path, each a context manager that patches the
port for its block: the readings that set the limits (``readings.py``)
and the tests hold the check against them."""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def state_unchanged():
    """The train step returns its state unchanged: no update."""
    import d3feat_tpu_torch.train.step as step

    return _patched(step, "optimizer_step", lambda *a, **k: None)


def half_the_pairs():
    """The train step leaves out half of its correspondences and takes the
    mean over the rest."""
    import d3feat_tpu_torch.train.step as step

    orig = step._forward_losses

    def half(model, batch, *a, **kw):
        valid = batch["corr_valid"].clone()
        valid[valid.nonzero()[len(valid.nonzero()) // 2:, 0]] = False
        return orig(model, dict(batch, corr_valid=valid), *a, **kw)

    return _patched(step, "_forward_losses", half)


def lr_off():
    """The train step updates at 1.1 times the configured learning rate."""
    import d3feat_tpu_torch.train.step as step

    orig = step.learning_rate
    return _patched(step, "learning_rate", lambda config, epoch: 1.1 * orig(config, epoch))


def momentum_off():
    """The optimizer keeps momentum 0.9 where the configuration states
    another."""
    import d3feat_tpu_torch.train.optim as optim

    orig = optim.make_optimizer

    def make(config, model):
        opt = orig(config, model)
        for g in opt.param_groups:
            g["momentum"] = 0.9
        return opt

    return _patched(optim, "make_optimizer", make)


def momentum_dropped():
    """The optimizer forgets its momentum buffers after every step."""
    import d3feat_tpu_torch.train.step as step

    orig = step.optimizer_step

    def forget(config, optimizer, model, lr):
        orig(config, optimizer, model, lr)
        optimizer.state.clear()

    return _patched(step, "optimizer_step", forget)


def altered_answer():
    """The extractor's last fragment's descriptor rows shifted by one."""
    import d3feat_tpu_torch.eval.extract as ex

    orig = ex.FeatureExtractor.extract_many

    def altered(self, clouds):
        out = orig(self, clouds)
        d, s = out[-1]
        return out[:-1] + [(np.roll(d, 1, axis=0), s)]

    return _patched(ex.FeatureExtractor, "extract_many", altered)


def half_the_group():
    """The extractor runs half of each group and answers the rest with the
    mean of that half."""
    import d3feat_tpu_torch.eval.extract as ex

    orig = ex.FeatureExtractor.extract_many

    def half(self, clouds):
        out = orig(self, clouds[: len(clouds) // 2])
        mean = (np.mean([o[0].mean(0) for o in out], 0), np.mean([o[1].mean() for o in out]))
        return out + [(np.tile(mean[0], (len(c), 1)), np.full(len(c), mean[1], np.float32))
                      for c in clouds[len(clouds) // 2:]]

    return _patched(ex.FeatureExtractor, "extract_many", half)


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_pairs, lr_off, momentum_off,
                                  momentum_dropped, altered_answer, half_the_group)}
