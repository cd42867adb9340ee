"""What every kind's run shares: the log, the measured window (a
``bench.window`` range, under the profiler when traced), the traffic made
before the window opens, and the context a kind's ``run`` and ``check``
receive."""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Context(SimpleNamespace):
    """What a kind's ``run`` and ``check`` get: ``cell``, ``cfg_doc``,
    ``arch``, the port's ``cfg`` and ``model``, the benchmark's
    ``weights``, the recorder ``rec``, ``seed``, ``device``, ``traced``,
    ``window_seconds``; ``mark(name)`` closes a part of set-up."""

    def window(self):
        return Window(self.traced, self.device, self.rec, self.window_seconds)


class Window:
    """The measured window: a ``bench.window`` range under the profiler
    when traced; ``t0``, ``t1`` its ends on the host's clock, ``open_at``
    its start in epoch seconds. The recorder forgets what set-up recorded
    and snapshots the port's counters at the start and the end."""

    def __init__(self, traced: bool, device, rec, seconds: float):
        self.traced, self.device, self.prof, self.rec = traced, device, None, rec
        self.seconds = seconds

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.open_at = time.time()
        if self.traced:
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.range = record_function("bench.window")
        self.range.__enter__()
        sync(self.device)
        if self.traced and torch.device(self.device).type == "cuda":
            # the launches' events are placed on the profiler's clock from
            # this one, recorded on the idle stream right before a marker
            # kernel that the profiler times
            self.rec.origin = torch.cuda.Event(enable_timing=True)
            self.rec.origin.record()
            with record_function("bench.origin"):
                torch.zeros(1, device=self.device)
            sync(self.device)
        self.rec.clear()
        self.t0 = time.perf_counter()
        return self

    def open(self) -> bool:
        """Whether the window's ``seconds`` have not yet passed."""
        return time.perf_counter() - self.t0 < self.seconds

    def __exit__(self, *exc):
        sync(self.device)
        self.t1 = time.perf_counter()
        self.rec.close()
        self.range.__exit__(*exc)
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def prepared(gen, spec: dict, seconds: float):
    """The window's traffic, made before it opens: ``ceil(seconds x
    prepared_per_s)`` items of ``gen`` (the mix's ``prepared_per_s``, set
    well above the rate the program sustains), then, should the window
    outlast them, further items made inside it under the
    ``bench.traffic`` span. Returns (iterator, number made ahead)."""
    from torch.profiler import record_function

    n = math.ceil(seconds * float(spec["prepared_per_s"]))
    ready = [next(gen) for _ in range(n)]

    def items():
        yield from ready
        ready.clear()
        log("the window outlasted the traffic made ahead: making more inside it")
        while True:
            with record_function("bench.traffic"):
                item = next(gen)
            yield item

    return items(), n
