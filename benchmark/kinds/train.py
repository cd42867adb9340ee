"""Training: the port's train step (``train/step.py::make_train_step``) on
one ground-truth-posed pair a step, packed by the port's ``data/pack.py``
and copied to the card inside the window, in a closed loop.

A mix of this kind (``"kind": "train"``) states ``scenes``,
``point_budget`` (points a pair; a larger pair is cropped around a random
correspondence), ``num_corr`` (correspondences drawn a pair),
``corr_radius`` (m), ``translation`` (m), ``check_steps`` (the first
steps, which the check follows), ``warmup`` (steps after them),
``trace_seconds`` and ``prepared_per_s`` (pairs made before the window
opens, per second of it). Each pass is a permutation of all pairs drawn
from the seed; each cloud of a pair gets a fresh motion on every use.

Set-up builds one trainer, drives it through the check's steps with the
window's own feed and call, keeping its parameters and momentum buffers
on the host before and after each, and hands the same trainer to the
window.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Iterator, Tuple

import numpy as np

from harness import check, program
from harness.loop import log, prepared, sync
from harness.traffic import crop_pair_to_budget, load_scenes, move, pair_correspondences


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.frags, self.pairs = load_scenes(spec["scenes"])
        self.corr = pair_correspondences(spec["scenes"], self.frags, self.pairs,
                                         float(spec["corr_radius"]))
        self.rng = np.random.default_rng(seed)

    def make(self, k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(cloud 0, cloud 1, correspondences [M, 2], anchor distances [M, M])."""
        rng, spec = self.rng, self.spec
        i, j, pose = self.pairs[k]
        p0, p1, c = self.frags[i], self.frags[j], self.corr[k]
        budget = int(spec["point_budget"])
        if len(p0) + len(p1) > budget:
            w1 = (p1.astype(np.float64) @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
            m0, m1, c = crop_pair_to_budget(rng, p0, w1, c, budget)
            p0, p1 = p0[m0], p1[m1]
        n = min(int(spec["num_corr"]), len(c))
        sel = c[rng.choice(len(c), n, replace=False)]
        kp = p0[sel[:, 0]].astype(np.float64)
        dk = np.linalg.norm(kp[:, None] - kp[None], axis=-1).astype(np.float32)
        t = float(spec["translation"])
        return move(rng, p0, t), move(rng, p1, t), sel, dk

    def steps(self) -> Iterator[tuple]:
        while True:
            for k in self.rng.permutation(len(self.pairs)):
                yield self.make(int(k))


def run(ctx) -> SimpleNamespace:
    spec, rec = ctx.cell.traffic, ctx.rec
    traffic = Traffic(spec, ctx.seed)
    ctx.mark("scenes and correspondences")
    tr = program.Trainer(ctx.cfg, ctx.model, ctx.device, ctx.mark)
    gen = traffic.steps()
    steps = []
    params, bufs = tr.params(), tr.momentum()
    for k in range(int(spec["check_steps"])):
        rec.keep = True
        packed, metrics = tr.feed(next(gen))
        after = tr.params(), tr.momentum()
        steps.append({"packed": packed, "metrics": metrics, "kept": rec.kept,
                      "params": params, "bufs": bufs, "params_after": after[0],
                      "bufs_after": after[1]})
        params, bufs = after
        ctx.mark(f"check step {k}")
    rec.keep, rec.kept = False, None
    for _ in range(int(spec.get("warmup", 0))):
        tr.feed(next(gen))
    sync(ctx.device)
    ctx.mark("warm-up steps")
    items, n_made = prepared(gen, spec, ctx.window_seconds)
    ctx.mark(f"the window's {n_made} pairs")
    n, failed = 0, 0
    with ctx.window() as win:
        while win.open():
            _, m = tr.feed(next(items))
            n += 1
            failed += int(m.skipped > 0 or m.overflow > 0)
    return SimpleNamespace(win=win, calls=n, done=n, failed=failed, steps=steps, program=tr)


def check_numbers(res, ctx) -> dict:
    r = check.check_train(res.steps, ctx.weights, ctx.cfg_doc, ctx.arch, ctx.device)
    log(f"train check: {r}")
    return {k: r[k] for k in ("pyramid_miss", "start_miss", "loss_gap", "grad_gap",
                              "update_gap")}
