"""Per-fragment feature extraction (port of ``d3feat_tpu.eval.extract``:
``FeatureExtractor`` and ``generate_features``).

Each fragment, or group of ``batch_fragments`` fragments riding the cloud
axis, is packed into the smallest capacity bucket and runs through one
extraction step on the device; the valid rows come back to the host
(``ops/transfer.py::to_host``).
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.data.pack import choose_bucket, pack_fragments, pack_single
from d3feat_tpu_torch.eval.registration import FragmentFeatures
from d3feat_tpu_torch.ops.transfer import to_host
from d3feat_tpu_torch.train.step import make_extract_step
from d3feat_tpu_torch.utils.profiling import span

DEFAULT_BUCKETS = (4096, 8192, 16384, 32768)


def _bucket_caps(config: D3FeatConfig, cap0: int) -> PyramidCaps:
    """Scale the per-level capacities proportionally to the level-0 bucket."""
    base = config.caps
    scale = cap0 / base.points[0]
    pts = [cap0]
    for p in base.points[1:]:
        pts.append(max(64, int(np.ceil(p * scale))))
    return PyramidCaps(points=tuple(pts), neighbors=base.neighbors, corr=base.corr)


class FeatureExtractor:
    """Bucketed extraction: fragment [N, 3] -> (descriptors, scores).

    ``on_overflow``: ``"retry"`` re-runs in the next larger bucket (raising
    when the largest still overflows), ``"warn"`` keeps the degraded result
    with a warning, ``"raise"`` fails at once. ``model`` must live on
    ``device`` (default ``"cuda"``, which raises when CUDA is missing)."""

    def __init__(self, config: D3FeatConfig, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, batch_fragments: int = 1,
                 on_overflow: str = "retry", device="cuda", impl: str = "auto"):
        self.device = resolve_device(device)
        if next(model.parameters()).device.type != self.device.type:
            raise ValueError(f"model is not on {self.device}")
        if on_overflow not in ("retry", "warn", "raise"):
            raise ValueError(f"on_overflow: {on_overflow!r}")
        self.config = config
        self.model = model
        self.buckets = tuple(sorted(buckets))
        self.batch_fragments = max(1, int(batch_fragments))
        self.on_overflow = on_overflow
        self.impl = impl
        self._steps: Dict[tuple, object] = {}
        self._calls = itertools.count()  # the ``port.extract`` spans' numbers

    def _step_for(self, cap0: int, num_clouds: int):
        key = (cap0, num_clouds)
        if key not in self._steps:
            # a copy, not a rebuild from to_dict(): a subclass keeps its
            # architecture() (a deformable model its block list)
            cfg = dataclasses.replace(self.config, caps=_bucket_caps(self.config, cap0))
            self._steps[key] = make_extract_step(cfg, num_clouds=num_clouds, impl=self.impl)
        return self._steps[key]

    def _handle_overflow(self, overflowed: bool, cap0: int, context: str) -> bool:
        """True when the caller should retry in a larger bucket."""
        if not overflowed:
            return False
        larger = [c for c in self.buckets if c > cap0]
        if self.on_overflow == "retry" and larger:
            return True
        msg = (f"pyramid capacity overflow extracting {context} at bucket {cap0}: "
               f"neighbor lists were truncated and descriptors/scores are degraded. "
               f"Raise the capacity buckets or recalibrate the neighbor caps.")
        if self.on_overflow == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=5)
            return False
        raise RuntimeError(msg)

    def _run(self, step, batch, bucket: int, rows: int, context: str):
        """(descriptors [rows, D], scores [rows] on the host, whether to
        retry in a larger bucket) of one extraction step on the packed
        ``batch``: the first ``rows`` rows of its outputs, the valid ones."""
        with span("extract.step"):
            tensors = {k: _to_device(v, self.device) for k, v in batch.items()}
            feats, scores, overflow = step(self.model, tensors)
        with span("extract.copy_out"):
            feats, scores, overflowed = to_host(feats, scores, overflow, rows)
        return feats, scores, self._handle_overflow(overflowed, bucket, context)

    def extract(self, points: np.ndarray):
        """(descriptors [N, D], scores [N]) for one fragment."""
        with span("extract", next(self._calls)):
            return self._extract_one(points)

    def _extract_one(self, points: np.ndarray):
        n = len(points)
        cap0 = choose_bucket(n, self.buckets)
        while True:
            with span("extract.pack"):
                batch = pack_single(points, np.ones((n, 1), np.float32), point_capacity=cap0)
            feats, scores, retry = self._run(self._step_for(cap0, 2), batch, cap0, n,
                                             f"fragment of {n} pts")
            if retry:
                cap0 = min(c for c in self.buckets if c > cap0)
                continue
            return feats, scores

    def extract_many(self, clouds):
        """[(descriptors, scores)] for a list of fragments,
        ``batch_fragments`` per step."""
        with span("extract", next(self._calls)):
            if self.batch_fragments == 1:
                return [self._extract_one(c) for c in clouds]
            return self._extract_groups(clouds)

    def _extract_groups(self, clouds):
        b = self.batch_fragments
        results = []
        for i in range(0, len(clouds), b):
            group = clouds[i : i + b]
            per_frag = choose_bucket(max(len(c) for c in group), self.buckets)
            while True:
                cap0 = per_frag * b
                with span("extract.pack"):
                    batch = pack_fragments(group, point_capacity=cap0, num_clouds=b)
                feats, scores, retry = self._run(self._step_for(cap0, b), batch, per_frag,
                                                 sum(len(c) for c in group),
                                                 f"group of {len(group)} fragments")
                if retry:
                    per_frag = min(c for c in self.buckets if c > per_frag)
                    continue
                break
            row = 0
            for c in group:
                n = len(c)
                results.append((feats[row : row + n], scores[row : row + n]))
                row += n
        return results


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    with span("sync.copy_in"):  # pageable memory: the copy blocks the host
        return torch.from_numpy(array).to(device)


def generate_features(
    extractor: FeatureExtractor,
    testset,
    *,
    save_path: Optional[str] = None,
    desc_name: str = "D3Feat",
    verbose: bool = False,
) -> Dict[str, FragmentFeatures]:
    """Extract every fragment of ``testset`` grouped per scene; optionally
    persist in the reference's .npy layout (test.py:113-127)."""
    per_scene: Dict[str, FragmentFeatures] = {}
    counters: Dict[str, int] = {}
    for i in range(len(testset)):
        scene = testset.scene_of[i]
        pts = testset.get_fragment(i)
        desc, scores = extractor.extract(pts)
        fid = counters.get(scene, 0)
        counters[scene] = fid + 1
        per_scene.setdefault(scene, FragmentFeatures()).add(fid, pts, desc, scores)
        if verbose:
            print(f"[extract] {scene}/cloud_bin_{fid}: {len(pts)} pts")
    if save_path is not None:
        for scene, feats in per_scene.items():
            feats.save(save_path, scene, desc_name)
    return per_scene
