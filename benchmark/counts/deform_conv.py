"""Operations and bytes of one K6 launch (a deformable KPConv's neighbour
sums, forward: ``ops/cuda/deform_conv.cu``), counted from the algorithm's
work on the listed neighbour pairs, whatever implements it.

``LAUNCHER`` is the port's launcher whose calls are counted (left out
where the program has no ``ops/deform_conv.py``), ``SYMBOLS`` its foreign
launch functions, whose device time is the kernel's.
``sizes`` reads a call's sizes from its arguments: ``kp`` kernel points,
``cin`` channels, ``q`` valid queries, ``s`` valid supports, ``pairs``
listed (query, neighbour) pairs, ``per_query`` whether each query has its
own kernel points (the deformed sums) or all share them (the offset
KPConv's sums); the counts are device scalars, read after the window.
Operations: per pair and kernel point the squared distance (8), the
linear influence (4: a square root, a scale, a subtraction, a clamp), the
range test (1) and the weighted sum (2 per input channel); per pair the
density test (``cin``). Bytes: each input read once (query and support
points, support features, the lists as int32, the kernel points), each
output written once (the weighted sums, the density, and with per-query
kernel points the least squared distances), float32."""

import importlib.util

SYMBOLS = ("deform_sums_launch",)
# named only where the program has K6: a traced run wraps every named
# launcher, and a program without the module (an earlier commit) has
# nothing to count
if importlib.util.find_spec("d3feat_tpu_torch.ops.deform_conv") is not None:
    LAUNCHER = "deform_conv.deform_sums_kernel"


def sizes(args, kw) -> dict:
    q_pts, s_pts, inds, x, kp = (kw[k] if k in kw else args[i] for i, k in enumerate(
        ("q_pts", "s_pts", "inds", "x", "kernel_points")))
    return {"kp": kp.shape[-2], "cin": x.shape[1], "q": (q_pts[:, 0] < 1.0e5).sum(),
            "s": (s_pts[:, 0] < 1.0e5).sum(), "pairs": (inds < s_pts.shape[0]).sum(),
            "per_query": kp.dim() == 3}


def work(launch: dict):
    kp, cin, q, s, pairs = (launch[k] for k in ("kp", "cin", "q", "s", "pairs"))
    ops = pairs * kp * (8 + 4 + 1 + 2 * cin) + pairs * cin
    points = q * kp * 3 if launch["per_query"] else kp * 3
    out = q * kp * cin + q + (q * kp if launch["per_query"] else 0)
    nbytes = 4 * (q * 3 + s * 3 + s * cin + pairs + points + out)
    return ops, nbytes
