"""Per-fragment feature extraction (port of
``d3feat_tpu.eval.extract.FeatureExtractor``).

Each fragment, or group of ``batch_fragments`` fragments riding the cloud
axis, is packed into the smallest capacity bucket and runs through one
extraction step on the device; the valid rows come back to the host.
"""

from __future__ import annotations

import warnings
from typing import Dict, Sequence

import numpy as np
import torch

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.config import D3FeatConfig, PyramidCaps
from d3feat_tpu_torch.data.pack import choose_bucket, pack_fragments, pack_single
from d3feat_tpu_torch.train.step import make_extract_step

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

    def _step_for(self, cap0: int, num_clouds: int):
        key = (cap0, num_clouds)
        if key not in self._steps:
            cfg = D3FeatConfig.from_dict(self.config.to_dict())
            cfg.caps = _bucket_caps(self.config, cap0)
            self._steps[key] = make_extract_step(cfg, num_clouds=num_clouds, impl=self.impl)
        return self._steps[key]

    def _handle_overflow(self, overflow, cap0: int, context: str) -> bool:
        """True when the caller should retry in a larger bucket."""
        if not bool(overflow):
            return False
        larger = [c for c in self.buckets if c > cap0]
        if self.on_overflow == "retry" and larger:
            return True
        msg = (f"pyramid capacity overflow extracting {context} at bucket {cap0}: "
               f"neighbor lists were truncated and descriptors/scores are degraded. "
               f"Raise the capacity buckets or recalibrate the neighbor caps.")
        if self.on_overflow == "warn":
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return False
        raise RuntimeError(msg)

    def _run(self, step, batch):
        tensors = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        return step(self.model, tensors)

    def extract(self, points: np.ndarray):
        """(descriptors [N, D], scores [N]) for one fragment."""
        n = len(points)
        cap0 = choose_bucket(n, self.buckets)
        while True:
            batch = pack_single(points, np.ones((n, 1), np.float32), point_capacity=cap0)
            feats, scores, overflow = self._run(self._step_for(cap0, 2), batch)
            if self._handle_overflow(overflow, cap0, f"fragment of {n} pts"):
                cap0 = min(c for c in self.buckets if c > cap0)
                continue
            return feats[:n].cpu().numpy(), scores[:n, 0].cpu().numpy()

    def extract_many(self, clouds):
        """[(descriptors, scores)] for a list of fragments,
        ``batch_fragments`` per step."""
        b = self.batch_fragments
        if b == 1:
            return [self.extract(c) for c in clouds]
        results = []
        for i in range(0, len(clouds), b):
            group = clouds[i : i + b]
            per_frag = choose_bucket(max(len(c) for c in group), self.buckets)
            while True:
                cap0 = per_frag * b
                batch = pack_fragments(group, point_capacity=cap0, num_clouds=b)
                feats, scores, overflow = self._run(self._step_for(cap0, b), batch)
                if self._handle_overflow(overflow, per_frag,
                                         f"group of {len(group)} fragments"):
                    per_frag = min(c for c in self.buckets if c > per_frag)
                    continue
                break
            feats = feats.cpu().numpy()
            scores = scores.cpu().numpy()
            row = 0
            for c in group:
                n = len(c)
                results.append((feats[row : row + n], scores[row : row + n, 0]))
                row += n
        return results
