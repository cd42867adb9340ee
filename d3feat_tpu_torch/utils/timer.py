"""Wall-clock timing and running statistics (port of
``d3feat_tpu.utils.timer``, copied as it is).

Counterparts of the reference meters (reference: utils/timer.py:4-56),
used by the trainer for the data-time/model-time split the reference logs
every 100 iterations (reference: trainer.py:128-135).
"""

from __future__ import annotations

import time


class Timer:
    """tic/toc accumulator with average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.diff = 0.0
        self.avg = 0.0
        self._start = 0.0

    def tic(self):
        self._start = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self._start
        self.total_time += self.diff
        self.calls += 1
        self.avg = self.total_time / self.calls
        return self.avg if average else self.diff


class AverageMeter:
    """Running mean / variance / sum of a scalar stream."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.sq_sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / self.count
        self.sq_sum += float(val) ** 2 * n

    @property
    def var(self) -> float:
        if self.count == 0:
            return 0.0
        return self.sq_sum / self.count - self.avg**2
