"""K6: the deformable KPConv's neighbour sums, forward: kernel wrapper,
plain PyTorch twin and launch counters.

A deformable KPConv (``models/kpconv.py::deformable_kpconv``) takes two
neighbour sums: the offset KPConv's, on the conv's shared kernel points,
and the deformed one, on each query's moved kernel points, where a
neighbour in range of no moved point is dropped. Each is, per query,
``weighted [KP, Cin]``, the sum over the (kept) neighbours of the
kernel-point influence times the neighbour's feature row, and the density,
the count of (kept) neighbours whose feature row sums above 0, at least 1.
The product with the weights (a matmul, ``models/kpconv.py::contract``)
and the modulations stay outside.

The kernel is ``ops/cuda/deform_conv.cu``; ``deform_sums_plain`` is its
twin, the gather route the port has always run (it materialises the
``[Q, nn, Cin]`` gathered rows and the ``[Q, nn, KP, 3]`` differences).
``deform_sums`` picks one (``impl``: ``"auto"``, ``"plain"``,
``"kernel"``) and counts what it did: ``deform_sums.launches`` the sums
run on K6, ``deform_sums.launches_fallback`` those run by the gather route.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from d3feat_tpu_torch.ops import build

KP = 15      # kernel points the kernel weighs: KPConv's and D3Feat's disposition
C_MAX = 512  # channels: four a thread of a 128-thread CTA


def deform_sums_plain(q_pts, s_pts, neighb_inds, x, kernel_points, *, extent: float,
                      drop: bool, influence: str = "linear", aggregation: str = "sum",
                      compute_dtype=torch.float32):
    """Twin of K6 (the port's gather route), differentiable in ``x`` and
    per-query ``kernel_points``: (weighted [Q, KP, Cin] float32, density [Q]
    float32, min_d2 [Q, KP] or None).

    ``q_pts`` [Q, 3], ``s_pts`` [S, 3], ``neighb_inds`` [Q, nn] with shadow
    ``S`` (a point at ``SHADOW_COORD`` with a zero feature row), ``x`` [S,
    Cin]. Shared ``kernel_points`` [KP, 3] take the rigid gather KPConv's
    arithmetic (``models/kpconv.py::kpconv``): squared distances by the
    expansion ``|n|^2 - 2 n.kp + |kp|^2`` clamped at 0, rows gathered in the
    compute dtype. Per-query ``kernel_points`` [Q, KP, 3] take the
    deformable KPConv's: differences, then the sum of squares, ``min_d2``
    the least over every neighbour (the shadow included), rows gathered in
    float32. With ``drop`` a neighbour within ``extent`` of no kernel point
    is replaced by the shadow, so it neither adds to the sums nor counts in
    the density. Both products multiply compute-dtype operands in float32."""
    from d3feat_tpu_torch.models.kpconv import SHADOW_COORD, gather_rows
    from d3feat_tpu_torch.models.kpconv import influence as influence_of

    per_query = kernel_points.dim() == 3
    kp = kernel_points.float() if per_query else kernel_points.detach().float()
    inds = neighb_inds.long()
    s_ext = torch.cat([s_pts.detach().float(), s_pts.new_full((1, 3), SHADOW_COORD)])
    nb = s_ext[inds] - q_pts.detach().float()[:, None, :]                  # [Q, nn, 3]
    min_d2 = None
    if per_query:
        diff = nb[:, :, None, :] - kp[:, None, :, :]                        # [Q, nn, KP, 3]
        sq_d = (diff * diff).sum(-1)                                        # [Q, nn, KP]
        min_d2 = sq_d.amin(1)  # ties share the gradient, as jnp.min's
    else:
        n_sq = (nb * nb).sum(-1)                                            # [Q, nn]
        kp_sq = (kp * kp).sum(-1)                                           # [KP]
        cross = (nb[..., 0:1] * kp[:, 0] + nb[..., 1:2] * kp[:, 1]) + nb[..., 2:3] * kp[:, 2]
        sq_d = torch.clamp(n_sq[..., None] - 2.0 * cross + kp_sq, min=0.0)
    w = influence_of(sq_d, extent, influence)
    if drop:
        in_range = (sq_d < extent**2).any(-1)                               # [Q, nn]
        inds = torch.where(in_range, inds, s_pts.shape[0])
        w = torch.where(in_range[:, :, None], w, 0.0)
    if aggregation == "closest":
        w = w * F.one_hot(sq_d.argmin(-1), kp.shape[-2]).to(w.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation {aggregation!r}")
    w = w.transpose(1, 2)                                                   # [Q, KP, nn]
    neighb_x = gather_rows(x if per_query else x.to(compute_dtype), inds)   # [Q, nn, Cin]
    weighted = torch.bmm(w.to(compute_dtype).float(), neighb_x.to(compute_dtype).float())
    active = neighb_x.float().sum(-1) > 0.0
    density = torch.clamp(active.sum(-1), min=1).float()
    return weighted, density, min_d2


_SUMS_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
    ctypes.c_int] + [ctypes.c_void_p] * 5


def deform_sums_kernel(q_pts, s_pts, inds, x, kernel_points, *, extent: float, drop: bool):
    """Launch K6: the contract of ``deform_sums_plain`` at linear influence,
    sum aggregation and float32, ``inds`` int32. No gradient."""
    for t, name in ((q_pts, "q_pts"), (s_pts, "s_pts"), (x, "x"),
                    (kernel_points, "kernel_points")):
        build.require(t, torch.float32, name)
    build.require(inds, torch.int32, "inds")
    nq, nn = inds.shape
    ns, c = x.shape
    per_query = kernel_points.dim() == 3
    if (q_pts.shape != (nq, 3) or s_pts.shape != (ns, 3) or c > C_MAX
            or kernel_points.shape != ((nq, KP, 3) if per_query else (KP, 3))):
        raise ValueError("deform_sums: bad shape arguments")
    dev = x.device
    flag = torch.empty((max(ns, 1),), dtype=torch.uint8, device=dev)  # rows summing above 0
    weighted = torch.empty((nq, KP, c), dtype=torch.float32, device=dev)
    density = torch.empty((nq,), dtype=torch.float32, device=dev)
    min_d2 = torch.empty((nq, KP), dtype=torch.float32, device=dev) if per_query else None
    fn = build.launcher("deform_conv", "deform_sums_launch", _SUMS_ARGS)
    # the twin compares with extent**2 and divides by extent, both as float32
    rc = fn(build.ptr(q_pts), build.ptr(s_pts), build.ptr(inds), build.ptr(x),
            build.ptr(kernel_points), nq, ns, nn, c, int(per_query), extent, extent**2,
            int(drop), build.ptr(flag), build.ptr(weighted), build.ptr(density),
            build.ptr(min_d2) if per_query else None, build.stream_of(x))
    build.check(rc, "deform_sums_kernel")
    deform_sums.launches += 1
    return weighted, density, min_d2


def uses_kernel(impl: str, x, kernel_points, influence: str, aggregation: str,
                compute_dtype) -> bool:
    """Whether ``deform_sums`` launches K6: ``"auto"`` on a CUDA tensor when
    the kernel computes the call (linear influence, sum aggregation,
    float32, ``KP`` kernel points, at most ``C_MAX`` channels) and no
    gradient is needed; ``"kernel"`` always, raising where it cannot;
    ``"plain"`` never (``ops.build.uses_kernel``)."""
    if not build.uses_kernel(impl, x):
        return False
    fits = (influence == "linear" and aggregation == "sum" and compute_dtype == torch.float32
            and kernel_points.shape[-2] == KP and x.shape[1] <= C_MAX
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or kernel_points.requires_grad)))
    if impl == "auto":
        return fits
    if not fits:
        raise ValueError("deform_sums kernel: linear influence, sum aggregation, float32, "
                         f"{KP} kernel points, <= {C_MAX} channels, no gradient")
    return True


def deform_sums(q_pts, s_pts, neighb_inds, x, kernel_points, *, extent: float, drop: bool,
                influence: str = "linear", aggregation: str = "sum",
                compute_dtype=torch.float32, impl: str = "auto"):
    """One neighbour sum of a deformable KPConv, on K6 or by the gather
    route (``uses_kernel``): arguments and results as ``deform_sums_plain``'s."""
    if uses_kernel(impl, x, kernel_points, influence, aggregation, compute_dtype):
        return deform_sums_kernel(q_pts.float().contiguous(), s_pts.float().contiguous(),
                                  neighb_inds.to(torch.int32).contiguous(), x.contiguous(),
                                  kernel_points.float().contiguous(), extent=extent, drop=drop)
    deform_sums.launches_fallback += 1
    return deform_sums_plain(q_pts, s_pts, neighb_inds, x, kernel_points, extent=extent,
                             drop=drop, influence=influence, aggregation=aggregation,
                             compute_dtype=compute_dtype)


deform_sums.launches = 0
deform_sums.launches_fallback = 0
