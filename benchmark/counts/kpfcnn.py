"""Operations of one KPFCNN forward (the whole step's model work), counted
from the valid rows of each level and the listed pairs of each search, the
block list and its widths, whatever implements it.

A KPConv costs what ``counts/band_conv.py`` counts; a deformable KPConv
adds its offset KPConv (3 KP outputs) and, per pair and kernel point, the
distance to the moved point (8) and the range test; a unary layer 2 Cin
Cout + 2 Cout a row; a max pool and the upsample a comparison or copy per
pair and channel; the head and the normalisation 10 D a row. A training
step counts three forwards (``TRAIN_FACTOR``): the backward's products
take twice the forward's."""

import importlib.util
import os

TRAIN_FACTOR = 3


def _conv_work():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "band_conv.py")
    spec = importlib.util.spec_from_file_location("bench_counts_band_conv_for_kpfcnn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.work


def forward_ops(blocks, counts: dict, kp: int, out_dim: int) -> float:
    """Operations of one forward: ``blocks`` (encoder, decoder) as
    ``reference.model.blocks`` gives them, ``counts`` with ``rows`` [L]
    valid rows, ``conv`` [L] and ``pool`` [L - 1] listed pairs."""
    conv_work = _conv_work()
    enc, dec = blocks
    rows, conv, pool = counts["rows"], counts["conv"], counts["pool"]
    ops = 0.0

    def kpconv(l, strided, cin, cout, deformable):
        q = rows[l + 1] if strided else rows[l]
        pairs = pool[l] if strided else conv[l]
        launch = dict(kp=kp, cin=cin, cout=cout, q=q, s=rows[l], pairs=pairs)
        w = conv_work(launch)[0]
        if deformable:
            w += conv_work(dict(launch, cout=3 * kp))[0] + pairs * kp * 9
        return w

    def unary(n, cin, cout):
        return n * (2 * cin * cout + 2 * cout)

    for b in enc:
        l, strided = b["layer"], b["strided"]
        nq = rows[l + 1] if strided else rows[l]
        if b["kind"] == "simple":
            ops += kpconv(l, strided, b["in_dim"], b["out_dim"] // 2, b["deformable"])
            ops += nq * b["out_dim"]
            continue
        mid = b["out_dim"] // 4
        if b["in_dim"] != mid:
            ops += unary(rows[l], b["in_dim"], mid)
        ops += kpconv(l, strided, mid, mid, b["deformable"]) + nq * mid
        ops += unary(nq, mid, b["out_dim"])
        if strided:
            ops += pool[l] * b["in_dim"]
        if b["in_dim"] != b["out_dim"]:
            ops += unary(nq, b["in_dim"], b["out_dim"])
        ops += 2 * nq * b["out_dim"]
    for b in dec:
        n = rows[b["layer"]]
        if b["kind"] == "nearest_upsample":
            ops += rows[b["layer"] - 1] * b["in_dim"]
        elif b["kind"] in ("unary", "last_unary"):
            ops += unary(n, b["in_dim"], out_dim if b["kind"] == "last_unary" else b["out_dim"])
    return ops + rows[0] * 10 * out_dim
