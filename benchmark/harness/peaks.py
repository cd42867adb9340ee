"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit): the card's power limit is printed beside every share.

The compute peak is the dense TF32 tensor-core rate, the fastest at which
this card produces float32-accurate products, so no float32 implementation
can read above 100 % of it."""

PEAK_FLOPS = 495e12      # TF32 dense, FLOP/s
PEAK_BYTES = 3.35e12     # HBM3, bytes/s
