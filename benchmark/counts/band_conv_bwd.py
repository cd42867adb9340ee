"""Operations and bytes of one K4 launch (the rigid KPConv backward of one
block, ``ops/cuda/band_conv_bwd.cu``), counted from the algorithm's work on
the valid neighbour pairs, whatever implements it.

Sizes as in ``counts/band_conv.py`` (the same arguments). ``SYMBOLS`` are
K4's own foreign launch functions: the lists' transpose that its launcher
runs first is a kernel of its own and is not K4's time. Operations: the
weights' gradient from the forward's weighted rows (2 KP Cin Cout a
query); with ``dx``, the weighted rows' gradient (2 KP Cin Cout a query),
the influence again (12 a pair and kernel point) and its scatter to the
neighbours (2 Cin a pair and kernel point). Bytes: the output gradient,
the weighted rows, the weights, the points and lists read once; the
weights' gradient and, with ``dx``, the input's gradient written once,
float32."""

from harness.manifest import load_module

LAUNCHER = "band_conv.band_conv_bwd_kernel"
SYMBOLS = ("band_conv_bwd_launch", "band_conv_bwd_bf16_launch")
sizes = load_module("counts", "band_conv").sizes


def work(launch: dict):
    kp, cin, cout = launch["kp"], launch["cin"], launch["cout"]
    q, s, pairs = launch["q"], launch["s"], launch["pairs"]
    ops = q * 2 * kp * cin * cout
    nbytes = 4 * (q * cout + q * kp * cin + kp * cin * cout + kp * cin * cout)
    if launch["dx"]:
        ops += q * 2 * kp * cin * cout + pairs * kp * (12 + 2 * cin)
        nbytes += 4 * (q * 3 + s * 3 + pairs + kp * 3 + s * cin)
    return ops, nbytes
