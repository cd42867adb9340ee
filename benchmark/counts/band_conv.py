"""Operations and bytes of one K2 launch (the rigid KPConv forward of one
block, ``ops/cuda/band_conv.cu``), counted from the algorithm's work on
the valid neighbour pairs, whatever implements it.

``LAUNCHER`` is the port's launcher whose calls are counted, ``SYMBOLS``
its foreign launch functions, whose device time is the kernel's.
``sizes`` reads a call's sizes from its arguments: ``kp`` kernel points,
``cin`` and ``cout`` channels, ``q`` valid queries, ``s`` valid supports,
``pairs`` listed (query, neighbour) pairs, ``dx`` whether the input's
gradient is needed (device scalars, read after the window). Operations:
per pair and kernel point the linear influence (12: the squared distance
8, a square root, a scale, a subtraction, a clamp) and the weighted sum
(2 per input channel); per pair the density test (``cin``); per query the
product with the weights (2 KP Cin Cout) and the division (``cout``).
Bytes: each input read once (support points and features, query points,
the lists as int32, the weights and kernel points), the output written
once, float32."""

LAUNCHER = "band_conv.band_conv_kernel"
SYMBOLS = ("band_conv_launch", "band_conv_bf16_launch")


def sizes(args, kw) -> dict:
    q_rows, s_rows, w = (kw[k] if k in kw else args[i]
                         for i, k in ((0, "q_rows"), (3, "s_rows"), (5, "weights")))
    kpn, cin, cout = w.shape
    return {"kp": kpn, "cin": cin, "cout": cout, "q": (q_rows[:, 3] >= 0).sum(),
            "s": (s_rows[:, 0] < 1.0e5).sum(), "pairs": kw["lists"].lcnt.sum(),
            "dx": bool(kw.get("need_dx", True))}


def work(launch: dict):
    kp, cin, cout = launch["kp"], launch["cin"], launch["cout"]
    q, s, pairs = launch["q"], launch["s"], launch["pairs"]
    ops = pairs * kp * (12 + 2 * cin) + pairs * cin + q * (2 * kp * cin * cout + cout)
    nbytes = 4 * (s * (3 + cin) + q * 3 + pairs + kp * cin * cout + kp * 3 + q * cout)
    return ops, nbytes
