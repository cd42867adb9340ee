"""A kernel's share of its roofline in a traced window: the least time the
card could take for the work of all the calls that ``counts/<kernel>.py``
counted (the larger of operations over ``PEAK_FLOPS`` and bytes over
``PEAK_BYTES``, call by call) over the device time of the kernel's own
foreign launches (its ``SYMBOLS``), in percent."""

from harness.peaks import PEAK_BYTES, PEAK_FLOPS


def share(run, kernel: str):
    """The share, or None where the window holds no call or no device time
    of ``kernel``."""
    calls = run.launches.get(kernel) or []
    if not calls or not run.trace:
        return None
    count = run.counts(kernel)
    seconds = sum(run.trace["port_s"].get(s, 0.0) for s in count.SYMBOLS)
    if not seconds:
        return None
    least = sum(max(o / PEAK_FLOPS, b / PEAK_BYTES) for o, b in map(count.work, calls))
    return 100.0 * least / seconds
