"""Tracing of the port (the counterpart of ``d3feat_tpu.utils.profiling``).

The reference's only instrumentation is wall-clock tic/toc pairs split into
data vs. model time (reference: trainer.py:71-135, utils/timer.py); the
trainer's meters keep that split. Here, besides:

* :func:`span` — a named range of the port in the ``torch.profiler``
  trace, ``port.<name>``, or ``port.<name>[<arg>]`` with a short argument
  (readers take the name before ``[``). A span's parent is the range that
  encloses it on the same thread. The ranges sit in the same Kineto trace
  as the device's events, so they share their clock. A span is a
  function-scope ``RecordFunction`` (``torch._C._profiler.
  _RecordFunctionFast``, as ``torch.compile``'s generated code records its
  ranges), a ``cpu_op`` event of the trace: ``record_function``'s user
  annotations also get device-side copies (``gpu_user_annotation``) that a
  reader of the device's operations would have to leave out by name;
* :func:`device_tensor` — ``torch.tensor`` of a host value on a device, a
  host sync on the card, recorded as one;
* :func:`trace` — context manager around ``torch.profiler.profile`` (host
  activity, and the device's when CUDA is in use) writing a Chrome trace
  JSON (``chrome://tracing``, Perfetto) into ``logdir``.

**On and off.** A span records while a torch profiler records (the
benchmark's traced window, or :func:`trace`). Otherwise :func:`span`
returns one shared no-op context after one check of the profiler's state:
it enters no ``RecordFunction`` and reads no clock. There is no other
switch.

**The spans** (``port.`` left out; ``[...]`` the argument):

* extraction entry (``eval/extract.py``): ``extract[<call>]`` around each
  ``extract`` or ``extract_many`` call, numbered from 0 for each
  extractor; ``extract.pack``; ``extract.step`` (the copies in, the
  extraction step); ``extract.copy_out`` (the valid rows and the overflow
  flag copied back, ``ops/transfer.py::to_host``, once a step);
* train step (``train/step.py``): ``train.step[<call>]``, numbered from 0
  for each step function; ``train.forward`` (pyramid, ``apply_kpfcnn``,
  losses); ``train.backward``; ``train.allreduce`` (with a process group);
  ``train.finite`` (the metrics' stack, the per-leaf finite check, up to
  and including their copy to the host); ``train.optimizer``;
* pyramid (``ops/pyramid.py``): ``pyramid``; ``pyramid.frame``;
  ``pyramid.level[<l>]`` (level l's sorted state, band route);
  ``pyramid.search[conv<l>|pool<l>|up<l>]``; ``pyramid.subsample[<l>]``;
  on the card's band route ``pyramid.capture`` (a spec's first call: one
  eager build and the capture of its CUDA graph, each under the spans
  above) and ``pyramid.replay`` (every call: the copies in, the replay,
  the copies of the outputs);
* model (``models/kpfcnn.py``): ``model.block[enc:<i>:<name>]`` and
  ``model.block[dec:<i>:<name>]`` around each encoder and decoder block;
  ``model.head``;
* deformable KPConv (``models/kpconv.py::deformable_kpconv``, inside its
  block's ``model.block``): ``deform.offsets`` (the offset KPConv and the
  moved kernel points), ``deform.sums`` (the deformed neighbour sums, K6
  or the gather route), ``deform.contract`` (the modulations, the product
  with the weights and the density); no sync;
* host syncs: ``sync.<site>`` around each statement that blocks the host
  on the device, so a site's count of ranges is its count of syncs and
  their duration the host's wait. On the band route: ``const.head``
  (``models/kpfcnn.py``: host constants copied to the card), ``copy_in``
  (``eval/extract.py``), ``copy_out`` (``ops/transfer.py``), ``metrics``
  (``train/step.py``, also the eval step's); the band route's pyramid has
  none. On the plain twins and the original-order route also ``window_width``
  (``ops/select.py::tile_windows``), ``candidates``, ``row_groups``
  (``ops/neighbors.py``) and ``transpose_end`` (``ops/band_lists.py``).
  The CPU counts the same sites, none of which waits there.

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
from typing import Iterator

import torch
from torch._C._profiler import _RecordFunctionFast

TRACE_FILE = "trace.json"  # the Chrome trace that ``trace`` writes into its logdir

_recording = torch._C._autograd._profiler_enabled  # whether a torch profiler records
_OFF = contextlib.nullcontext()


def span(name: str, arg=None):
    """The range ``port.<name>``, or ``port.<name>[<arg>]`` (a tuple
    ``arg`` joined by ``:``), while a torch profiler records; otherwise
    the shared no-op context. ``arg`` is formatted only while recording."""
    if not _recording():
        return _OFF
    if arg is None:
        return _RecordFunctionFast(f"port.{name}")
    if isinstance(arg, tuple):
        arg = ":".join(map(str, arg))
    return _RecordFunctionFast(f"port.{name}[{arg}]")


def device_tensor(value, device, dtype=None, *, site: str) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``. On the card a
    copy from pageable host memory, which waits until the stream has run
    what was queued before it: the sync range ``port.sync.<site>``."""
    with span(f"sync.{site}"):
        return torch.tensor(value, dtype=dtype, device=device)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``<logdir>/trace.json`` (``TRACE_FILE``):
    host activity, and the device's when CUDA is available, with the
    port's spans. Yields the profiler, whose ``key_averages()`` give the
    same events as tables."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
