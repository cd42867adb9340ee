"""The traced window's share of the card's compute peak: the model work of
every extraction step in the window (``counts/kpfcnn.py``, one forward a
step) over the window's seconds and ``PEAK_FLOPS``, in percent."""

from harness.peaks import PEAK_FLOPS


def read(run):
    if run.kind != "extract" or not run.pyramid_counts:
        return None
    ops = sum(run.forward_ops(c) for c in run.pyramid_counts)
    return 100.0 * ops / (run.window_s * PEAK_FLOPS)
