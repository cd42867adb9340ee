"""Fragments returned to the host in the window over the window's seconds
(host clock, the window closed by a synchronize after the last call), in
a cell whose every call is one fragment. There the host's launches and
waits pace each call, and the rate moves with the host's speed from run
to run by more than an end-to-end bound can hold (``PERF.md`` §2), so it
is read per layer and moves the calls' 95th percentile. None where a
call carried more than one fragment."""

from harness.manifest import load_module

_rate = load_module("metrics", "extract_fragments_per_s").read


def read(run):
    if not run.calls or run.done != run.calls:
        return None
    return _rate(run)
