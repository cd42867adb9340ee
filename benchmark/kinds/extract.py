"""Extraction: groups of fragments through the port's
``FeatureExtractor.extract_many``, in a closed loop (one caller sends the
next group when the last returns).

A mix of this kind (``"kind": "extract"``) states ``scenes`` (a pattern
of held-out scene files), ``batch_fragments``, ``on_overflow``,
``buckets``, ``translation`` (m), ``warmup`` (groups after the buckets'
warm-up), ``check_groups`` (groups of the window's first pass that the
check samples), ``trace_seconds`` (the longest traced window) and
``prepared_per_s`` (groups made before the window opens, per second of
it). Each pass is a permutation of all fragments drawn from the seed, cut
into groups; every fragment gets a fresh motion on every use. With
``batch_fragments`` 1 each call is one fragment, which the extractor runs
as ``FeatureExtractor.extract`` does (``pack_single``: the lengths
``[n, 0]``).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Iterator, List

import numpy as np

from harness import check, program
from harness.loop import log, prepared, sync
from harness.traffic import load_scenes, move

BLOCK_FRAGMENTS = 8  # fragments a block of the check pools (one group of extract-b8)


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.frags, _ = load_scenes(spec["scenes"])
        self.b = int(spec["batch_fragments"])
        if len(self.frags) % self.b:
            raise ValueError("the fragments do not divide into whole groups")
        self.rng = np.random.default_rng(seed)

    def warmup_groups(self) -> List[List[np.ndarray]]:
        """For each capacity bucket that a whole group can fall in, the
        group of the largest fragments that fit it, so every bucket the
        window can reach is built and warm before it opens."""
        by_size = sorted(range(len(self.frags)), key=lambda i: len(self.frags[i]))
        t = float(self.spec["translation"])
        groups = []
        for cap in sorted(self.spec["buckets"]):
            fit = [i for i in by_size if len(self.frags[i]) <= cap]
            if len(fit) >= self.b:
                groups.append([move(self.rng, self.frags[i], t) for i in fit[-self.b:]])
        return groups

    def groups(self) -> Iterator[List[np.ndarray]]:
        t = float(self.spec["translation"])
        while True:
            order = self.rng.permutation(len(self.frags))
            for g in range(0, len(order), self.b):
                yield [move(self.rng, self.frags[i], t) for i in order[g:g + self.b]]


def run(ctx) -> SimpleNamespace:
    spec, rec = ctx.cell.traffic, ctx.rec
    traffic = Traffic(spec, ctx.seed)
    ctx.mark("scenes")
    ex = program.extractor(ctx.cfg, ctx.model, spec, ctx.device)
    for g in traffic.warmup_groups():
        ex.extract_many(g)
    gen = traffic.groups()
    for _ in range(int(spec.get("warmup", 0))):
        ex.extract_many(next(gen))
    sync(ctx.device)
    ctx.mark("warm-up groups")
    items, n = prepared(gen, spec, ctx.window_seconds)
    ctx.mark(f"the window's {n} groups")
    pass_len = len(traffic.frags) // traffic.b
    sample = set(np.random.default_rng([ctx.seed, 1]).choice(
        pass_len, int(spec["check_groups"]), replace=False).tolist())
    kept, lat, frags, failed = {}, [], 0, 0
    with ctx.window() as win:
        while win.open():
            group = next(items)
            i = len(lat)
            rec.keep = i in sample
            rec.valid_rows = sum(len(g) for g in group)
            t = time.perf_counter()
            try:
                out = ex.extract_many(group)
            except RuntimeError as e:
                log(f"group {i}: {e}")
                failed += 1
                out = None
            lat.append(time.perf_counter() - t)
            frags += len(group)
            if rec.keep and out is not None:
                kept[i] = (group, out, rec.kept)
            rec.keep, rec.kept = False, None
    return SimpleNamespace(win=win, calls=len(lat), done=frags, lat=lat, failed=failed,
                           kept=kept, program=ex)


def check_numbers(res, ctx) -> dict:
    """``pyramid_miss``, the largest over the sampled calls; each share of
    rows off, the largest over blocks of consecutive sampled calls that
    hold ``BLOCK_FRAGMENTS`` fragments between them, over the block's
    rows. A group of 8 is a block of its own; calls of one fragment are
    pooled 8 to a block, since one near-tie of a density count moves a
    large share of one small fragment's rows (``PERF.md`` §6). A
    call answered without a step of the extractor (no pyramid built)
    misses in full."""
    nums, block, frags = {}, [], 0
    for i in sorted(res.kept):
        group, outputs, kept = res.kept[i]
        if kept is None:
            n = sum(len(g) for g in group)
            r = {"pyramid_miss": 1, "rows": n, "desc_off_rows": n, "clear_rows": n,
                 "score_off_rows": n}
        else:
            r = check.check_group(group, outputs, kept, ctx.weights, ctx.cfg_doc, ctx.arch,
                                  ctx.device)
        log(f"group {i}: {r}")
        nums["pyramid_miss"] = max(nums.get("pyramid_miss", 0), r["pyramid_miss"])
        block.append(r)
        frags += len(group)
        if frags >= BLOCK_FRAGMENTS:
            _pool(nums, block)
            block, frags = [], 0
    if block:
        _pool(nums, block)
    return nums


def _pool(nums: dict, block: list):
    """Each share of rows off over the block's rows, kept where it is the
    largest yet."""
    rows, clear = sum(r["rows"] for r in block), sum(r["clear_rows"] for r in block)
    for key, off, base in (("desc_off_share", "desc_off_rows", rows),
                           ("score_off_share", "score_off_rows", clear)):
        share = 100.0 * sum(r[off] for r in block) / base if base else 0.0
        nums[key] = max(nums.get(key, 0.0), share)
