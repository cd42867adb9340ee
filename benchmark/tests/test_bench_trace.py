"""The trace reader on a hand-made trace: busy time as the union of the
device's operations and the port's launch intervals, the port's own
kernel events left to its intervals, spans' device time by the operator
that launched each kernel, and idle gaps by the span the host was in."""

from types import SimpleNamespace

import pytest
import torch

from harness.trace import IncompleteTrace, summarize

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


U = 1_000_000  # the hand-made times below are in ms, the profiler's in ns


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0, tid=1):
        self._v = (name, dev, start * U, dur * U, corr, linked, tid)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def duration_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def start_thread_id(self): return self._v[6]


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_summary_by_hand():
    ev = [Ev("bench.window", CPU, 0, 1000, corr=1),
          Ev("bench.origin", CPU, 0, 1, corr=5),
          Ev("aten::zeros", CPU, 0.5, 0.1, corr=6),
          Ev("fill", CUDA, 2, 0.001, linked=6),          # the origin's marker kernel
          Ev("bench.pyramid", CPU, 100, 300, corr=2),
          Ev("aten::mm", CPU, 150, 10, corr=3),
          Ev("gemm", CUDA, 200, 100, linked=3),         # inside the pyramid span
          Ev("aten::add", CPU, 500, 10, corr=4),
          Ev("add", CUDA, 600, 50, linked=4),
          Ev("port_kernel", CUDA, 800, 40, linked=99),   # the profiler's copy of a port kernel
          Ev("aten::cat", CPU, 900, 1, corr=7),
          Ev("void gemm3_kernel<float, 64>(float*)", CUDA, 950, 20, linked=7),  # a port kernel the profiler linked
          Ev("bench.pyramid", CUDA, 100, 300)]           # device-side range: not an operation
    # one port launch from 778 ms to 878 ms after the origin (the marker at 2 ms)
    s = summarize(_prof(ev), ("bench.pyramid",), [("band_conv_launch", 0.778, 0.878)],
                  {"gemm3_kernel"})
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.1 + 0.05 + 0.1 + 0.001 * 1e-3)
    assert s["device_s"]["bench.pyramid"] == pytest.approx(0.1)
    assert s["port_s"]["band_conv_launch"] == pytest.approx(0.1)
    names = [n for n, _ in s["breakdown"]["device_ops"]]
    assert "port_kernel" not in names and "port:band_conv_launch" in names
    assert not any("gemm3" in n for n in names)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # idle 0-200 (but the marker) and 300-600 ms; inside the pyramid span
    # (100-400): 100-200, 300-400; 0-100, 400-600, 650-780, 880-1000 outside
    # it
    assert gaps["bench.pyramid"] == pytest.approx(0.2)
    # the first 1 ms waits in the origin's range
    assert gaps["bench.origin"] == pytest.approx(0.001)
    assert gaps["host (no span)"] == pytest.approx(0.1 + 0.2 + 0.13 + 0.12 - 0.001, abs=1e-5)


def test_no_window_or_no_device_event():
    with pytest.raises(IncompleteTrace):
        summarize(_prof([Ev("aten::mm", CPU, 0, 10, corr=3)]))
    with pytest.raises(IncompleteTrace):
        summarize(_prof([Ev("bench.window", CPU, 0, 1000, corr=1)]))
