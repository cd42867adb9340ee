"""K4's share of its roofline over all its launches in the traced window
of a train cell (``harness/roofline.py``, ``counts/band_conv_bwd.py``):
the device time is that of K4's own foreign launches, without the lists'
transpose that its launcher runs first, in percent."""

from harness import roofline


def read(run):
    return roofline.share(run, "band_conv_bwd") if run.kind == "train" else None
