"""Reading the profiler's trace of a traced window.

Every operation on the card (kernels, copies, sets: the profiler's device
events, less the device-side copies of the benchmark's own ``bench.*``
ranges) is a busy interval; the union of those inside the ``bench.window``
range is ``busy_s``. A kernel belongs to a span when the PyTorch operator that
launched it (linked by the profiler's correlation id) started inside one
of the span's ranges on the same thread.

The port launches its own kernels through ``ctypes``: the profiler links
them to no operator and has been seen to leave most of them out. Each such
foreign launch is timed instead by CUDA events recorded on the stream
right before and after the foreign call (``program.launch_intervals``):
its interval, placed on the window's
timeline from the window's start, stands for its kernels: the profiler's
events of those kernels (unlinked, or linked to a span and inside the
interval, or bearing a kernel name of the port's sources) are left out.
The stream is one. The events' clock is placed on
the profiler's by the origin event, recorded on the idle stream at the
window's start right before a marker kernel whose start the profiler
records.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch


_PLAY_NS = 20_000  # how far an event may sit from a kernel beside it on the stream


class IncompleteTrace(RuntimeError):
    """The trace holds fewer of the port's own kernels than it launched."""


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _gaps(intervals, lo, hi):
    """Idle (start, end) gaps between the busy intervals inside [lo, hi]."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def kernel_base(name: str) -> str:
    """A device event's kernel name without return type, template and
    arguments: ``void f<int>(float*)`` is ``f``."""
    name = name[5:] if name.startswith("void ") else name
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()


def summarize(prof, span_names=(), port_launches=(), port_names=frozenset()) -> dict:
    """``busy_s`` and ``window_s`` of the ``bench.window`` range, device
    seconds and range counts of each ``bench.*`` span (``device_s``), device
    seconds of each foreign launch function of the port (``port_s``, from
    ``port_launches`` [(function, start s, end s)] after the origin event,
    whose marker kernel the ``bench.origin`` range launched), the device
    operations that took most time and the
    idle time by the innermost span the host was in, each gap split where
    the host's span changes. Raises
    ``IncompleteTrace`` when the window holds no linked device event."""
    cpu_type = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    ranges = defaultdict(list)       # name -> [(tid, start, end)]
    launches = {}                    # correlation id -> (tid, start)
    device = []                      # (start, end, name, linked correlation id)
    for e in events:
        name = e.name()
        if e.device_type() == cpu_type:
            if name.startswith("bench."):
                ranges[name].append((e.start_thread_id(), e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
            launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif not name.startswith("bench."):
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                           e.linked_correlation_id()))
    if not ranges.get("bench.window"):
        raise IncompleteTrace("the trace has no bench.window range")
    _, lo, hi = ranges["bench.window"][0]
    origin_ns = lo
    if port_launches:
        tid, o0, o1 = ranges["bench.origin"][0]
        marks = [s for s, _, _, c in device if c in launches
                 and launches[c][0] == tid and o0 <= launches[c][1] <= o1]
        if not marks:
            raise IncompleteTrace("the trace lost the origin's marker kernel")
        origin_ns = min(marks)
    port = sorted((origin_ns + int(a * 1e9), origin_ns + int(b * 1e9), "port:" + n, None)
                  for n, a, b in port_launches)
    starts = [p[0] for p in port]

    def in_port(s, e):
        """Inside a launch's interval, within the two clocks' play."""
        i = bisect.bisect_right(starts, s + _PLAY_NS) - 1
        return i >= 0 and port[i][1] + _PLAY_NS >= e

    inside = [(max(s, lo), min(e, hi), n, c) for s, e, n, c in device
              if e > lo and s < hi and (c in launches or not port_launches)
              and not in_port(s, e) and kernel_base(n) not in port_names]
    if not inside:
        raise IncompleteTrace("the trace holds no device event in the window")
    inside += port
    busy = _union((s, e) for s, e, _, _ in inside)

    by_span = {}
    for name in span_names:
        rs = sorted(ranges.get(name, []), key=lambda r: r[1])
        by_span[name] = ([r[1] for r in rs], rs)
    device_s = defaultdict(float)
    for s, e, n, corr in inside:
        launch = launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        for name, (starts, rs) in by_span.items():
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and rs[i][2] >= t:
                if rs[i][0] == tid and rs[i][1] <= t:
                    device_s[name] += (e - s) * 1e-9
                    break
                i -= 1
    port_s = defaultdict(float)
    for n, a, b in port_launches:
        port_s[n] += b - a

    ops = defaultdict(float)
    for s, e, n, _ in inside:
        ops[n] += (e - s) * 1e-9
    named = {}
    for name, rs in ranges.items():
        if name != "bench.window":
            rs = sorted(rs, key=lambda r: r[1])
            named[name] = ([r[1] for r in rs], rs)
    all_starts = sorted(r[1] for _, (_, rs) in named.items() for r in rs)

    def host_at(t):
        """(innermost span at ``t`` or None, the end of that stretch)."""
        best = None
        for name, (starts_n, rs) in named.items():
            i = bisect.bisect_right(starts_n, t) - 1
            if i >= 0 and rs[i][2] > t and (best is None or rs[i][2] - rs[i][1] < best[2]):
                best = (name, rs[i][2], rs[i][2] - rs[i][1])
        if best:
            return best[0], best[1]
        j = bisect.bisect_right(all_starts, t)
        return None, all_starts[j] if j < len(all_starts) else hi

    gap_by = defaultdict(float)
    for gs, ge in _gaps([(s, e) for s, e, _, _ in inside], lo, hi):
        t = gs
        while t < ge:
            name, end = host_at(t)
            end = min(max(end, t + 1), ge)
            gap_by[name or "host (no span)"] += (end - t) * 1e-9
            t = end
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy * 1e-9, "window_s": (hi - lo) * 1e-9, "device_s": dict(device_s),
            "port_s": dict(port_s),
            "spans": {n: len(by_span[n][1]) for n in by_span},
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gap_by)}}
