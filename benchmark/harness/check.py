"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``reference/``).

Extraction: for each sampled group, the pyramid the extraction step built,
stage by stage (``reference.geometry.pyramid_misses``), then each
fragment's descriptors and scores in the caller's row order against the
reference's forward: the rows off by more than ``ROW_TOL`` (the kind
takes their share over blocks of 8 sampled fragments). Not
the widest gap: D3Feat's density count (neighbours whose features sum
above 0) is a step, and where such a sum is a near-tie the two float32
orders of summation may count differently, moving the rows downstream of
it by up to a few percent in sound runs. Training: for each of the first steps (driven through
the window's own call and feed at set-up), the pyramid, then the losses
and metrics the step returned, the first gradient as the optimizer got it
(its momentum buffer after step 1) and the parameters' change after the
steps, each by its worst leaf.

The reference's forward reads the program's pyramid once the stage checks
have passed it: independent float32 pyramids part at near-ties of the
radius and of the k-th distance, and one swapped neighbour moves a
descriptor by far more than rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import geometry, model as ref, strict_fp32

GATE_TIE = 1e-4  # |local-max margin| below which a score's gate may go either way
ROW_TOL = 1e-3   # a row whose descriptor (L2) or score differs by more is off


def _spec(cfg_doc: dict, arch: list) -> dict:
    conv, pool = ref.search_scales(cfg_doc, arch)
    return {"conv_r_scale": conv, "pool_r_scale": pool,
            "neighbor_caps": list(cfg_doc["caps"]["neighbors"])}


def _pyramid(kept: dict) -> dict:
    return {"points": kept["points"], "lengths": [ln.tolist() for ln in kept["lengths"]],
            "neighbors": kept["neighbors"], "pools": kept["pools"],
            "upsamples": kept["upsamples"], "masks": kept["masks"], "order": kept["order"]}


def _sorted_rows(kept: dict, n: int, device) -> torch.Tensor:
    """Row of the pyramid's level 0 that holds each of the ``n`` input rows
    (the inverse of its verified order; identity without one)."""
    if kept["order"] is None:
        return torch.arange(n, device=device)
    inv = torch.empty_like(kept["order"])
    inv[kept["order"]] = torch.arange(len(inv), device=device)
    return inv[:n].long()


def group_lengths(group, clouds: int) -> list:
    """The group's fragment lengths, with zeros for the empty cloud slots
    after them up to the pyramid's ``clouds``: the packing fills a step's
    unused slots with length 0 (``pack_single`` packs one fragment as
    ``[n, 0]``). Any other difference stays a ``lengths`` miss."""
    lengths = [len(g) for g in group]
    return lengths + [0] * (clouds - len(lengths))


def check_group(group, outputs, kept, weights, cfg_doc, arch, device) -> dict:
    """Misses of one extraction group's pyramid, and the shares and counts
    of its rows whose descriptor (L2) or score (rows whose gate is a
    near-tie left out, ``clear_rows`` the others) is off the reference's by
    more than ``ROW_TOL``; the widest gaps beside."""
    pts = torch.from_numpy(np.concatenate(group)).to(device)
    pyr = _pyramid(kept)
    lengths = group_lengths(group, len(pyr["lengths"][0]))
    misses = geometry.pyramid_misses(pyr, pts, lengths, cfg_doc, _spec(cfg_doc, arch))
    n = pts.shape[0]
    p = weights
    sorted_lens = pyr["lengths"][0]
    cloud = torch.repeat_interleave(torch.arange(len(sorted_lens), device=device),
                                    torch.tensor(sorted_lens, device=device))
    n0 = pyr["points"][0].shape[0]
    cloud = torch.cat([cloud, cloud.new_full((n0 - len(cloud),), len(sorted_lens) - 1)])
    with torch.no_grad(), strict_fp32():
        desc, scores, margin, _ = ref.forward(p, pyr, cfg_doc, arch, train=False,
                                              cloud_of_row=cloud)
    rows = _sorted_rows(kept, n, device)
    d_ref, s_ref, m_ref = desc[rows], scores[rows, 0], margin[rows]
    d_got = torch.from_numpy(np.concatenate([o[0] for o in outputs])).to(device)
    s_got = torch.from_numpy(np.concatenate([o[1] for o in outputs])).to(device)
    clear = m_ref.abs() >= GATE_TIE
    d_gap = (d_got - d_ref).norm(dim=1)
    s_gap = (s_got - s_ref).abs()
    # a gap that is not a number (an answer made of nothing) is off too
    d_off, s_off = ~(d_gap <= ROW_TOL), ~(s_gap[clear] <= ROW_TOL)
    return {"pyramid_miss": sum(misses.values()),
            "desc_off_share": 100.0 * float(d_off.float().mean()),
            "score_off_share": 100.0 * float(s_off.float().mean()),
            "desc_off_rows": int(d_off.sum()), "score_off_rows": int(s_off.sum()),
            "clear_rows": int(clear.sum()),
            "rows": n, "gate_ties": int((~clear).sum()), "desc_gap": float(d_gap.max()),
            "score_gap": float((s_gap * clear).max()), "misses": misses}


def _leaf_gap(got: dict, want: dict, keep):
    """(worst leaf's |norm(got) - norm(want)| over max(norm(want), median
    norm(want)), that leaf, the median leaf's gap) over the leaves in
    ``keep``."""
    norms = {k: float(want[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    gaps = {k: abs((float(got[k].norm()) if k in got else 0.0) - norms[k]) / max(norms[k], med)
            for k in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, float(np.median(list(gaps.values())))


def check_train(steps, weights, cfg_doc, arch, device) -> dict:
    """The reference takes each of the program's first steps again from the
    program's own state before it: ``steps`` [{packed pair, returned
    metrics, kept pyramid, the program's parameters and momentum buffers
    before the step (host copies) and after it}]; ``weights`` the
    benchmark's weights, which the first step starts from and which give
    the leaves that are not trained. Returns the pyramid misses, the
    leaves whose start differs from ``weights`` (and any momentum buffer
    before the first step), the widest relative gap of each step's losses
    and metrics, the worst leaf's gap of the momentum buffer the optimizer
    keeps after each step (after step 1 the first gradient as the
    optimizer got it, the gradient plus weight decay; after the later
    steps also what each step hands the next), and the worst leaf's gap of
    the parameters' change over the steps, the reference's change the sum
    of its steps. So every step's state is judged, lr and momentum with
    it, and a near-tie that the rounding of one step moves into the next
    cannot make the two sides part."""
    spec = _spec(cfg_doc, arch)
    lr = float(np.float32(cfg_doc["lr"]))
    trained = list(steps[0]["params"])
    start_miss = sum(int(not torch.equal(steps[0]["params"][k].to(device), weights[k]))
                     for k in trained) + len(steps[0]["bufs"])
    misses, step_gaps, step_updates, losses_seen = 0, [], [], []
    moved, buf_gaps = None, []
    total_got, total_ref = {}, {}
    for st in steps:
        p = {k: v.detach().clone() for k, v in weights.items() if k not in st["params"]}
        p.update({k: v.to(device).requires_grad_(True) for k, v in st["params"].items()})
        bufs = {k: v.to(device) for k, v in st["bufs"].items()}
        packed, metrics, kept = st["packed"], st["metrics"], st["kept"]
        pts = torch.from_numpy(packed.points).to(device)
        lengths = [int(v) for v in packed.lengths]
        pyr = _pyramid(kept)
        misses += sum(geometry.pyramid_misses(pyr, pts, lengths, cfg_doc, spec).values())
        rows = _sorted_rows(kept, pts.shape[0], device)
        valid = torch.from_numpy(packed.corr_valid).to(device)
        corr = torch.from_numpy(packed.corr).to(device).long()[valid]
        anc, pos = rows[corr[:, 0]], rows[corr[:, 1] + lengths[0]]
        dk = torch.from_numpy(packed.dist_keypts).to(device)[valid][:, valid]
        with strict_fp32():
            desc, scores, _, auxes = ref.forward(p, pyr, cfg_doc, arch, train=True)
            total, dl, det, acc, dpos, dneg = ref.losses(desc, scores, anc, pos, dk, cfg_doc)
            if auxes:
                total = total + ref.fitting_regulariser(auxes)
            grads = torch.autograd.grad(total, [p[k] for k in trained], allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p[k]))
                 for k, g in zip(trained, grads)}
        want = {k: float(v.detach()) for k, v in (("loss", total), ("desc_loss", dl),
                                                   ("det_loss", det), ("d_pos", dpos),
                                                   ("d_neg", dneg))}
        losses_seen.append((metrics.loss, want["loss"]))
        scale = 0.1 * abs(want["loss"])
        step_gaps.append(max(abs(getattr(metrics, k) - v) / max(abs(v), scale)
                             for k, v in want.items()))
        if moved is None:
            gnorm = {k: float(g.norm()) for k, g in grads.items()}
            med = float(np.median([v for v in gnorm.values() if v > 0]))
            moved = [k for k, v in gnorm.items() if v >= 1e-3 * med]
        before = {k: p[k].detach().clone() for k in moved}
        bufs = ref.sgd_step(p, grads, bufs, lr=lr, momentum=cfg_doc["momentum"],
                            weight_decay=cfg_doc["weight_decay"])
        buf_gaps.append(_leaf_gap({k: v.to(device) for k, v in st["bufs_after"].items()},
                                  bufs, moved))
        delta_ref = {k: p[k].detach() - before[k] for k in moved}
        delta_got = {k: st["params_after"][k].to(device) - before[k] for k in moved}
        step_updates.append(_leaf_gap(delta_got, delta_ref, moved)[0])
        for k in moved:
            total_got[k] = total_got.get(k, 0) + delta_got[k]
            total_ref[k] = total_ref.get(k, 0) + delta_ref[k]
        del p, grads, bufs, before, delta_ref, delta_got
    update = _leaf_gap(total_got, total_ref, moved)
    grad = max(buf_gaps)
    return {"pyramid_miss": misses, "start_miss": start_miss, "loss_gap": max(step_gaps),
            "step_gaps": step_gaps, "grad_gap": grad[0], "grad_worst_leaf": grad[1],
            "grad_median_gap": grad[2], "step_grad_gaps": [g[0] for g in buf_gaps],
            "update_gap": update[0],
            "update_worst_leaf": update[1], "update_median_gap": update[2],
            "step_update_gaps": step_updates, "losses": losses_seen,
            "leaves_compared": len(moved), "leaves_left_out": len(trained) - len(moved)}
