"""K2's share of its roofline over all its launches in the traced window
of an extraction cell (``harness/roofline.py``, ``counts/band_conv.py``):
the device time is that of K2's own foreign launches, in percent."""

from harness import roofline


def read(run):
    return roofline.share(run, "band_conv") if run.kind == "extract" else None
