"""KPFCNN of D3Feat in plain PyTorch: the block list, rigid and deformable
KPConv by gathers, the detector head, the descriptor and detector losses,
the deformable fitting regulariser, and the SGD step.

Follows D3Feat (Bai et al., CVPR 2020; XuyangBai/D3Feat.pytorch
``models/architectures.py``, ``models/blocks.py``) and KPConv (Thomas et
al., ICCV 2019; ``kernels/kernel_points.py``, the deformable KPConv and its
regulariser). Departures, each kept because the configuration states it:
the linear layers carry a bias and the batch norms are a learned bias
(``use_batch_norm`` false), as the served weights hold them; the output
layer has a bias; extraction normalises scores by each fragment's own
maximum, so fragments batched together do not perturb each other.

Parameters are a flat dict ``{name: tensor}`` with the names of the served
weight file (``encoder.<i>.<part>``, ``decoder.<i>.<part>``). A pyramid is
a dict of per-level lists: ``points`` [N_l, 3], ``neighbors`` [N_l, K_l]
(shadow N_l), ``pools`` [N_{l+1}, K_l] (shadow N_l), ``upsamples`` [N_l, 1]
(shadow N_{l+1}), ``masks`` [N_l] bool and ``lengths``.
"""

from __future__ import annotations

import torch

SHADOW = 1.0e6
LEAKY = 0.1
_CHUNK = 32768


def architecture(num_layers: int, deform_layers=()) -> list:
    """D3Feat's block list (``training_3DMatch.py``), with the blocks of the
    levels in ``deform_layers`` deformable, as KPConv's deformable KP-FCNN
    places them."""
    arch = ["simple", "resnetb"]
    for l in range(1, num_layers):
        if l in deform_layers:
            arch += ["resnetb_deformable_strided", "resnetb_deformable", "resnetb_deformable"]
        else:
            arch += ["resnetb_strided", "resnetb", "resnetb"]
    for _ in range(num_layers - 2):
        arch += ["nearest_upsample", "unary"]
    return arch + ["nearest_upsample", "last_unary"]


def blocks(cfg: dict, arch: list):
    """(encoder, decoder, encoder skip positions, decoder concat positions):
    each block a dict of name, kind, layer, in_dim, out_dim, radius,
    strided, deformable, as D3Feat's constructor walks the list."""
    layer, r = 0, cfg["first_subsampling_dl"] * cfg["conv_radius"]
    in_dim, out_dim = cfg["in_features_dim"], cfg["first_features_dim"]
    enc, skips, skip_dims = [], [], []
    for i, name in enumerate(arch):
        if "strided" in name or "upsample" in name:
            skips.append(i)
            skip_dims.append(in_dim)
        if "upsample" in name:
            break
        enc.append(dict(name=name, kind=name.split("_")[0], layer=layer, in_dim=in_dim,
                        out_dim=out_dim, radius=r, strided="strided" in name,
                        deformable="deform" in name))
        in_dim = out_dim // 2 if name == "simple" else out_dim
        if "strided" in name:
            layer, r, out_dim = layer + 1, r * 2, out_dim * 2
    dec, concats = [], []
    start = next(i for i, n in enumerate(arch) if "upsample" in n)
    for j, name in enumerate(arch[start:]):
        if j > 0 and "upsample" in arch[start + j - 1]:
            in_dim += skip_dims[layer]
            concats.append(j)
        dec.append(dict(name=name, kind=name, layer=layer, in_dim=in_dim, out_dim=out_dim,
                        radius=r, strided=False, deformable=False))
        in_dim = out_dim
        if "upsample" in name:
            layer, r, out_dim = layer - 1, r * 0.5, out_dim // 2
    return enc, dec, skips, concats


def search_scales(cfg: dict, arch: list):
    """(conv radius scale per level, pool radius scale per level): the
    deformable radius on a level whose convs are deformable, and on a
    strided block that is."""
    scale = cfg["deform_radius"] / cfg["conv_radius"]
    conv, pool, layer_blocks = [], [], []
    for i, b in enumerate(arch):
        if "upsample" in b:
            break
        if "strided" not in b:
            layer_blocks.append(b)
            if i < len(arch) - 1 and "upsample" not in arch[i + 1]:
                continue
        conv.append(scale if any("deform" in x for x in layer_blocks[:-1]) else 1.0)
        if "strided" in b:
            pool.append(scale if "deform" in b else 1.0)
        layer_blocks = []
    return conv, pool + [1.0] * (len(conv) - len(pool))


def lrelu(x):
    return torch.where(x >= 0, x, LEAKY * x)


def gather(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``inds``; index ``len(x)`` reads a zero row."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])[inds.long()]


def linear_influence(d2: torch.Tensor, extent: float) -> torch.Tensor:
    """max(1 - d / extent, 0), with no gradient through sqrt at d = 0."""
    pos = d2 > 0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)
    return torch.clamp(1.0 - d / extent, min=0.0)


def density(nx: torch.Tensor) -> torch.Tensor:
    """Count of the gathered neighbours ``nx`` [b, K, C] whose features sum
    above 0, at least 1."""
    return torch.clamp((nx.sum(-1) > 0).sum(-1), min=1).to(nx.dtype)


def _conv_rows(q, s_ext, x_ext, inds, weights, kp, extent):
    nb = s_ext[inds] - q[:, None, :]                                   # [b, K, 3]
    d2 = ((nb[:, :, None, :] - kp[None, None]) ** 2).sum(-1)            # [b, K, KP]
    w = linear_influence(d2, extent)
    nx = x_ext[inds]                                                   # [b, K, Cin]
    wf = torch.einsum("bkp,bkc->bpc", w, nx)                            # [b, KP, Cin]
    kpn, cin, cout = weights.shape
    out = wf.reshape(-1, kpn * cin) @ weights.reshape(kpn * cin, cout)
    return out / density(nx)[:, None]


def kpconv(q, s, inds, x, weights, kp, extent, chunk: int = 0):
    """Rigid KPConv, linear influence, sum aggregation: [Q, Cout], divided
    by the count of neighbours whose features sum above 0 (D3Feat's
    density normalisation). ``chunk`` rows at a time when given."""
    s_ext = torch.cat([s, s.new_full((1, 3), SHADOW)])
    x_ext = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    inds = inds.long()
    if not chunk or q.shape[0] <= chunk:
        return _conv_rows(q, s_ext, x_ext, inds, weights, kp, extent)
    return torch.cat([_conv_rows(q[i:i + chunk], s_ext, x_ext, inds[i:i + chunk], weights, kp,
                                 extent) for i in range(0, q.shape[0], chunk)])


def deformable_kpconv(q, s, inds, x, p, prefix, extent):
    """KPConv's deformable KPConv: offsets from a rigid KPConv on the
    offset kernel points plus a bias, kernel points moved by offsets times
    the extent, neighbours out of range of every moved point dropped.
    Returns ([Q, Cout], (min_d2 [Q, KP], deformed points [Q, KP, 3],
    extent)) for the regulariser."""
    kp = p[prefix + "kernel_points"]
    kpn = kp.shape[0]
    off = kpconv(q, s, inds, x, p[prefix + "offset_weights"], p[prefix + "offset_kernel_points"],
                 extent) + p[prefix + "offset_bias"]
    deformed = off.reshape(-1, kpn, 3) * extent + kp
    inds = inds.long()
    s_ext = torch.cat([s, s.new_full((1, 3), SHADOW)])
    nb = s_ext[inds] - q[:, None, :]
    d2 = ((nb[:, :, None, :] - deformed[:, None, :, :]) ** 2).sum(-1)  # [Q, K, KP]
    min_d2 = d2.amin(1)
    in_range = (d2 < extent ** 2).any(-1)
    eff = torch.where(in_range, inds, s.shape[0])
    w = torch.where(in_range[:, :, None], linear_influence(d2, extent), 0.0)
    nx = gather(x, eff)
    wf = torch.einsum("bkp,bkc->bpc", w, nx)
    weights = p[prefix + "weights"]
    _, cin, cout = weights.shape
    out = wf.reshape(-1, kpn * cin) @ weights.reshape(kpn * cin, cout)
    return out / density(nx)[:, None], (min_d2, deformed, extent)


def unary(x, p, prefix, relu=True):
    y = x @ p[prefix + "linear.w"] + p[prefix + "linear.b"] + p[prefix + "norm.bias"]
    return lrelu(y) if relu else y


def _conv(block, x, pyr, p, prefix, cfg, chunk):
    l = block["layer"]
    q = pyr["points"][l + 1] if block["strided"] else pyr["points"][l]
    inds = pyr["pools"][l] if block["strided"] else pyr["neighbors"][l]
    extent = block["radius"] * cfg["KP_extent"] / cfg["conv_radius"]
    if block["deformable"]:
        return deformable_kpconv(q, pyr["points"][l], inds, x, p, prefix + "conv.", extent)
    return kpconv(q, pyr["points"][l], inds, x, p[prefix + "conv.weights"],
                  p[prefix + "conv.kernel_points"], extent, chunk), None


def apply_block(block, x, pyr, p, prefix, cfg, chunk=0):
    """(output, a deformable conv's aux or None) of one block."""
    kind = block["kind"]
    if kind == "simple":
        y, aux = _conv(block, x, pyr, p, prefix, cfg, chunk)
        return lrelu(y + p[prefix + "norm.bias"]), aux
    if kind == "resnetb":
        mid = block["out_dim"] // 4
        h = unary(x, p, prefix + "unary1.") if block["in_dim"] != mid else x
        h, aux = _conv(block, h, pyr, p, prefix, cfg, chunk)
        h = lrelu(h + p[prefix + "norm_conv.bias"])
        h = unary(h, p, prefix + "unary2.", relu=False)
        sc = gather(x, pyr["pools"][block["layer"]]).amax(1) if block["strided"] else x
        if block["in_dim"] != block["out_dim"]:
            sc = unary(sc, p, prefix + "shortcut.", relu=False)
        return lrelu(h + sc), aux
    if kind == "nearest_upsample":
        return gather(x, pyr["upsamples"][block["layer"] - 1][:, 0]), None
    if kind == "unary":
        return unary(x, p, prefix), None
    if kind == "last_unary":
        return x @ p[prefix + "linear.w"] + p[prefix + "linear.b"], None
    raise ValueError(kind)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def head(x, pyr, cloud_of_row=None, gate=True):
    """Detection scores [N, 1] and, with ``gate``, the local-max margin of
    each row (the largest over channels of its value less its
    neighbourhood's largest other value; >= 0 where the row is a local
    max). ``cloud_of_row`` [N] normalises each cloud by its own maximum,
    else one maximum over all rows."""
    if cloud_of_row is None:
        f = x / (x.amax() + 1e-6)
    else:
        nc = int(cloud_of_row.max()) + 1
        cmax = torch.full((nc,), -torch.inf, device=x.device).scatter_reduce(
            0, cloud_of_row, x.amax(1), reduce="amax")
        f = x / (cmax[cloud_of_row, None] + 1e-6)
    nbr = pyr["neighbors"][0]
    nf = gather(f, nbr)                                                 # [N, K, D]
    count = torch.clamp((nf.sum(-1) != 0).sum(-1, keepdim=True), min=1).to(f.dtype)
    local = softplus(f - nf.sum(1) / count)
    depth = f / (1e-6 + f.amax(1, keepdim=True))
    scores = (local * depth).amax(1, keepdim=True)
    if not gate:
        return scores, None
    own = nbr.long() == torch.arange(len(f), device=f.device)[:, None]
    others = torch.where(own[:, :, None], -torch.inf, nf).amax(1)      # [N, D]
    margin = (f - others).amax(1)
    return scores * (margin >= 0).to(scores.dtype)[:, None], margin


def forward(p, pyr, cfg, arch, train: bool, cloud_of_row=None, chunk: int = _CHUNK):
    """(descriptors [N0, D], scores [N0, 1], gate margins or None, auxes)
    over a pyramid in its level-0 row order, features 1 on valid rows."""
    enc, dec, skips, concats = blocks(cfg, arch)
    mask0 = pyr["masks"][0]
    x = mask0.to(torch.float32)[:, None].expand(-1, cfg["in_features_dim"]).contiguous()
    stash, auxes = [], []
    ck = 0 if train else chunk
    for i, b in enumerate(enc):
        if i in skips:
            stash.append(x)
        x, aux = apply_block(b, x, pyr, p, f"encoder.{i}.", cfg, ck)
        if aux is not None:
            auxes.append(aux)
    for j, b in enumerate(dec):
        if j in concats:
            x = torch.cat([x, stash.pop()], 1)
        x, _ = apply_block(b, x, pyr, p, f"decoder.{j}.", cfg, ck)
    x = x * mask0[:, None]
    scores, margin = head(x, pyr, None if train else cloud_of_row, gate=not train)
    n2 = (x * x).sum(-1, keepdim=True)
    desc = torch.where(n2 > 0, x / torch.sqrt(torch.where(n2 > 0, n2, 1.0)), 0.0)
    return desc, scores, margin, auxes


def cdist(a, b):
    return torch.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1) + 1e-12)


def losses(desc, scores, anc, pos, dist_keypts, cfg):
    """D3Feat's circle and detector losses over the valid correspondences
    (``anc``, ``pos`` rows of ``desc``): (total without the regulariser,
    desc_loss, det_loss, accuracy, d_pos, d_neg)."""
    a, b = desc[anc], desc[pos]
    d = cdist(a, b)
    m = d.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=d.device)
    neg_mask = dist_keypts > cfg["safe_radius"]
    furthest_pos = torch.where(eye, d, 0.0).amax(1)
    closest_neg = torch.where(eye, d + 1e5, d).amin(1)
    avg_neg = (d.sum(1) - furthest_pos) / max(m - 1, 1)
    accuracy = (furthest_pos < closest_neg).float().mean() * 100.0
    ls, pm, nm = cfg["log_scale"], cfg["pos_margin"], cfg["neg_margin"]
    posv = d - 1e5 * neg_mask.float()
    pos_w = torch.clamp(posv - pm, min=0.0).detach()
    pos_arg = ls * (posv - pm) * pos_w
    negv = d + 1e5 * (~neg_mask).float()
    neg_w = torch.clamp(nm - negv, min=0.0).detach()
    neg_arg = ls * (nm - negv) * neg_w
    row = softplus(torch.logsumexp(pos_arg, -1) + torch.logsumexp(neg_arg, -1)) / ls
    col = softplus(torch.logsumexp(pos_arg, -2) + torch.logsumexp(neg_arg, -2)) / ls
    desc_loss = row.mean() + col.mean()
    det = ((furthest_pos - closest_neg) * (scores[anc, 0] + scores[pos, 0])).mean()
    total = cfg["desc_loss_weight"] * desc_loss + cfg["det_loss_weight"] * det
    return total, desc_loss, det, accuracy, furthest_pos.mean(), avg_neg.mean()


def fitting_regulariser(auxes, repulse_extent: float = 1.2, power: float = 1.0):
    """KPConv's deformable regulariser (``p2p_fitting_regularizer``): 2 x
    fitting (mean least squared distance of each moved kernel point to the
    inputs, over the conv's extent squared) plus the repulsion of moved
    kernel points closer than ``repulse_extent`` conv extents."""
    fit, rep = 0.0, 0.0
    for min_d2, deformed, extent in auxes:
        fit = fit + (min_d2 / extent ** 2).mean()
        locs = deformed / extent
        k = locs.shape[1]
        for i in range(k):
            other = torch.cat([locs[:, :i], locs[:, i + 1:]], 1).detach()
            dist = torch.sqrt(((other - locs[:, i:i + 1]) ** 2).sum(-1))
            rep = rep + (torch.clamp(dist - repulse_extent, max=0.0) ** 2).sum(1).mean() / k
    return power * (2.0 * fit + rep)


def sgd_step(p, grads, bufs, lr, momentum, weight_decay):
    """torch's SGD with momentum and L2 decay folded into the gradient, in
    place on ``p``; ``bufs`` {name: momentum buffer}, empty on the first
    step. Returns the buffers."""
    with torch.no_grad():
        for k, g in grads.items():
            d = g + weight_decay * p[k]
            bufs[k] = d.clone() if k not in bufs else bufs[k] * momentum + d
            p[k] -= lr * bufs[k]
    return bufs
