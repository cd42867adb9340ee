"""Profiling / tracing utilities (port of ``d3feat_tpu.utils.profiling``).

The reference's only instrumentation is wall-clock tic/toc pairs split into
data vs. model time (reference: trainer.py:71-135, utils/timer.py). Here the
same split is kept in the trainer meters, plus:

* :func:`trace` — context manager around ``torch.profiler.profile`` (host
  activity, and the device's when CUDA is in use) writing a Chrome trace
  JSON (``chrome://tracing``, Perfetto) into ``logdir``;
* :func:`annotate` — named host-side region that shows up in the trace
  (``torch.profiler.record_function``);
* :class:`SectionTimer` — wall-clock section stats for quick breakdowns
  without a trace viewer, synchronising the CUDA devices of its ``sync``
  tensors before it stops the clock.

A profile of ``torch.profiler`` can leave out launches of the kernels that
the port calls through ``ctypes`` (its CUPTI records missed some in one
run and not in the next), so a trace shows where the time goes but is no
count of launches: the kernel wrappers' own counters are, and a device time
that a check depends on is taken by CUDA events around calls queued behind
a held stream (``chip_smoke.py::held_ms``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"  # the Chrome trace that ``trace`` writes into its logdir


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``<logdir>/trace.json`` (``TRACE_FILE``):
    host activity, and the device's when CUDA is available. Yields the
    profiler, whose ``key_averages()`` give the same events as tables."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named region context (nests inside :func:`trace` output)."""
    return torch.profiler.record_function(name)


def _sync(tree) -> None:
    """Synchronise the CUDA device of every tensor in ``tree`` (a tensor or
    a nested tuple, list or dict of them)."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for d in devices:
        torch.cuda.synchronize(d)


class SectionTimer:
    """Accumulating per-section wall timer that syncs the device.

    >>> st = SectionTimer()
    >>> out = []
    >>> with st.section("pyramid", sync=out):
    ...     out.append(build_pyramid(...))
    >>> print(st.report())

    ``sync`` is walked when the block ends, so a list or dict filled inside
    the block is synchronised on.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t*1e3:.1f} ms total, "
                         f"{t/c*1e3:.2f} ms/call x{c}")
        return "\n".join(lines)
