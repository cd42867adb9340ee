"""bf16 panels of K2 and K4 (``panel_dtype="bfloat16"``), on the CPU.

- K2's bf16 twin against JAX ``band_conv(panel_dtype="bfloat16")`` (Pallas
  in interpret mode, threshold mode) on the inputs of
  ``tests/test_band_conv.py::test_band_conv_bf16_panels_close_to_f32``
  (900 points, radius 0.25, 24 neighbours, Cin = Cout = 32, 64-query
  tiles, 256-row chunks of 512-row windows): relative L2 < 1e-2 (that
  test's bound), density exactly equal, not equal to the f32 result, and
  nearer JAX's bf16 output than a tenth of the f32 result's distance to it
  (the twin rounds where the TPU kernel rounds; measured 4.4e-5 against
  3.3e-3).
- The density flag reads the rounded features: a row ``[1, -1 + 2**-12]``
  counts in f32 and not in bf16, in the twin as in the TPU kernel.
- K4's bf16 twin, through ``BandConvFn``, against the VJP of JAX
  ``band_conv_ad`` with bf16 panels: dx and dW relative L2 < 1e-2, and
  nearer than a tenth of the f32 gradients' distance (measured 1.3e-5 and
  9.6e-6 against 2.9e-3 and 3.2e-3).
- The kernels' bf16 route emulated from the list stage's lists (each list
  cut at the window's chunks, the rounded pieces kept as hi and lo rows,
  dx gathered from ``bf16(gs W^T)`` over the transposed lists): out, dx
  and dW within relative L2 1e-4 of the twins (the card's kernel-vs-twin
  bound) and within 1e-2 of JAX's.
- The kernels' bf16 products emulated step by step (each m16n8k16 step's
  16 exact products added with a truncating addition, 32-deep stages added
  in f32 round-to-nearest), at K2's level-4 second product and K4's dW:
  within the card's kernel-vs-twin bound (relative L2 < 1e-4) of the
  twin's f32 product of the same bf16 operands, and within the JAX bound
  (1e-2) of the f32 product.
- The unary layers: ``Linear`` in bf16 against JAX ``apply_linear`` with
  ``compute_dtype=bfloat16``, output and gradients: relative L2 < 1e-2,
  the output not equal to f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3feat_tpu.models.blocks import apply_linear as j_apply_linear
from d3feat_tpu.models.kernel_points import load_kernels as j_load_kernels
from d3feat_tpu.models.kpconv import init_kpconv
from d3feat_tpu.ops.neighbors import SortedLevel, make_level_frame, radius_neighbors_sorted
from d3feat_tpu.ops.pallas.band_conv import band_conv as j_band_conv
from d3feat_tpu.ops.pallas.band_conv import band_conv_ad
from d3feat_tpu_torch.models.blocks import Linear, band_query_tiles
from d3feat_tpu_torch.ops.band_conv import BandConvFn, band_conv
from d3feat_tpu_torch.ops.band_lists import band_lists
from d3feat_tpu_torch.ops.neighbors import band_windows, pick_chunk
from tests.torch_port_helpers import band_conv_bwd_from_lists, band_conv_from_lists
from tests.torch_port_helpers import torch_one_thread_module  # noqa: F401 (autouse fixture)

BOUND = 1e-2  # relative L2 of bf16 panels (tests/test_band_conv.py:139-195)
TWIN_BOUND = 1e-4  # the kernels' route against the twins (chip_smoke.py's BF16_TWIN_L2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _case(cin=32, cout=32):
    """(JAX inputs, port inputs, x_sorted [Ns_pad, Cin], W, kernel points,
    cotangent [Nq, Cout]) of one threshold-mode conv over the level of
    ``test_band_conv_bf16_panels_close_to_f32``."""
    rng = np.random.default_rng(5)
    n, cap = 900, 1024
    pts = (rng.uniform(0, 1, size=(n, 3)) * np.array([2.0, 1.5, 0.8])).astype(np.float32)
    padded = np.full((cap, 3), 1.0e6, np.float32)
    padded[:n] = pts
    lens = jnp.asarray(np.array([n, 0], np.int32))
    r, k, kpn, tile, band = 0.25, 24, 15, 64, 512
    axis, origin = make_level_frame(jnp.asarray(padded), lens, 2)
    lvl = SortedLevel(jnp.asarray(padded), lens, 2, axis, origin, band_pad=512)
    _, ov, thr, ptie = radius_neighbors_sorted(
        lvl, lvl, r, max_k=k, query_tile=tile, band_cap=band, interpret=True,
        raw_positions=True, with_threshold=True)
    assert not bool(ov)
    kp = j_load_kernels(r, kpn, deterministic=True).astype(np.float32)
    w = np.array(init_kpconv(jax.random.key(0), kpn, cin, cout, kp).weights)
    x = rng.normal(size=(cap, cin)).astype(np.float32)
    x[n:] = 0.0
    s_packed = np.asarray(lvl.s_packed)
    x_sorted = np.zeros((s_packed.shape[0], cin), np.float32)
    x_sorted[:cap] = x[np.asarray(lvl.order)]
    cot = rng.normal(size=(cap, cout)).astype(np.float32)

    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    key = t(lvl.key_sorted)
    q_rows, starts, ends, thr_p, ptie_p = band_query_tiles(
        {"q_rows": t(np.asarray(lvl.q_packed)[:4].T), "key_sorted": key}, {"key_sorted": key},
        2, r, tile, cap, t(thr), t(ptie))
    ws, we = band_windows(starts, ends, band)
    extent = r * 2.0 / 2.5
    port = dict(q_rows=q_rows.contiguous(), thr=thr_p, ptie=ptie_p, s_rows=t(s_packed[:, :4]),
                starts=ws, wends=we, query_tile=tile, extent=extent, chunk=pick_chunk(band))
    qp = np.zeros((8, q_rows.shape[0]), np.float32)
    qp[:4] = q_rows.numpy().T
    jx = dict(q_packed=jnp.asarray(qp), s_packed=jnp.asarray(s_packed),
              starts=jnp.asarray(starts.numpy().astype(np.int32)),
              ends=jnp.asarray(ends.numpy().astype(np.int32)),
              thr=jnp.asarray(thr_p.numpy()), ptie=jnp.asarray(ptie_p.numpy()),
              band=band, tile=tile, extent=extent)
    return jx, port, x_sorted, w, kp, cot


def _jax_fwd(jx, x, w, kp, pd):
    out, den = j_band_conv(
        jx["q_packed"], jnp.zeros((1, jx["q_packed"].shape[1]), jnp.int32), jx["s_packed"],
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(kp), jx["starts"], jnp.float32(jx["extent"]),
        jx["ends"], jx["thr"], jx["ptie"], band_cap=jx["band"], query_tile=jx["tile"],
        interpret=True, panel_dtype=pd)
    return np.asarray(out), np.asarray(den)[0]


def _port_fwd(port, x, w, kp, pd):
    out, den = band_conv(x=torch.from_numpy(x), weights=torch.from_numpy(w),
                         kernel_points=torch.from_numpy(kp), panel_dtype=pd, **port)
    return out.numpy(), den.numpy()


def test_k2_bf16_twin_matches_pallas_bf16():
    jx, port, x, w, kp, _ = _case()
    jout, jden = _jax_fwd(jx, x, w, kp, "bfloat16")
    tout, tden = _port_fwd(port, x, w, kp, "bfloat16")
    f32, _ = _port_fwd(port, x, w, kp, "float32")
    assert np.array_equal(tden, jden)
    assert rel_l2(tout, jout) < BOUND, rel_l2(tout, jout)
    assert rel_l2(tout, jout) < 0.1 * rel_l2(f32, jout), (rel_l2(tout, jout), rel_l2(f32, jout))
    assert rel_l2(tout, f32) < BOUND and not np.array_equal(tout, f32)
    assert np.abs(jout).max() > 0.1  # not vacuous


def test_density_flag_reads_the_rounded_features():
    """``[1, -1 + 2**-12]`` sums to 2**-12 > 0 in f32 and to 0 in bf16
    (-1 + 2**-12 rounds to -1): the density of every query that lists such
    a row drops by one in bf16, in the twin exactly as in the TPU kernel."""
    jx, port, _, _, kp, _ = _case()
    rng = np.random.default_rng(9)
    ns = port["s_rows"].shape[0]
    x = np.zeros((ns, 2), np.float32)
    x[:900] = np.abs(rng.normal(size=(900, 2)))
    x[:900:3] = (1.0, -1.0 + 2.0**-12)
    assert x[0].sum(dtype=np.float32) > 0
    w = rng.normal(size=(15, 2, 8)).astype(np.float32)
    _, jden = _jax_fwd(jx, x, w, kp, "bfloat16")
    _, tden = _port_fwd(port, x, w, kp, "bfloat16")
    _, fden = _port_fwd(port, x, w, kp, "float32")
    _, jfden = _jax_fwd(jx, x, w, kp, "float32")
    assert np.array_equal(tden, jden) and np.array_equal(fden, jfden)
    assert (tden < fden).sum() > 100 and (tden <= fden).all()


def _grads(port, x_sorted, w, kp, cot, pd):
    x = torch.tensor(x_sorted, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = BandConvFn.apply(x, wt, torch.from_numpy(kp), dict(port, panel_dtype=pd), "plain")
    loss = (out[: cot.shape[0]] * torch.from_numpy(cot)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (x, wt))]


def _jax_grads(jx, x_sorted, w, kp, cot, pd):
    def loss(x_in, w_in):
        out = band_conv_ad(jx["band"], jx["tile"], True, pd, jx["q_packed"],
                           jnp.zeros((1, jx["q_packed"].shape[1]), jnp.int32), jx["s_packed"],
                           x_in, w_in, jnp.asarray(kp), jx["starts"], jnp.float32(jx["extent"]),
                           jx["ends"], jx["thr"], jx["ptie"])
        return jnp.sum(out[: cot.shape[0]] * cot)

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1))(jnp.asarray(x_sorted), jnp.asarray(w))]


def test_k4_bf16_twin_matches_pallas_vjp_bf16():
    jx, port, x, w, kp, cot = _case(16, 16)
    jdx, jdw = _jax_grads(jx, x, w, kp, cot, "bfloat16")
    tdx, tdw = _grads(port, x, w, kp, cot, "bfloat16")
    fdx, fdw = _grads(port, x, w, kp, cot, "float32")
    assert rel_l2(tdx, jdx) < BOUND, rel_l2(tdx, jdx)
    assert rel_l2(tdw, jdw) < BOUND, rel_l2(tdw, jdw)
    assert rel_l2(tdx, jdx) < 0.1 * rel_l2(fdx, jdx), (rel_l2(tdx, jdx), rel_l2(fdx, jdx))
    assert rel_l2(tdw, jdw) < 0.1 * rel_l2(fdw, jdw), (rel_l2(tdw, jdw), rel_l2(fdw, jdw))
    assert rel_l2(tdx, fdx) < BOUND and rel_l2(tdw, fdw) < BOUND
    assert not np.array_equal(tdx, fdx) and not np.array_equal(tdw, fdw)
    assert np.abs(jdx).max() > 1e-2 and np.abs(jdw).max() > 1e-2  # not vacuous


def test_bf16_kernel_route_from_lists_matches_the_twins():
    """K2's and K4's bf16 kernels' decomposition over the lists, emulated in
    plain PyTorch, against the twins (which select from the windows) and
    against JAX's bf16 forward and VJP."""
    jx, port, x, w, kp, cot = _case(16, 16)
    lists = band_lists(**{k: port[k] for k in ("q_rows", "thr", "ptie", "s_rows", "starts",
                                                "wends", "query_tile")})
    geo = (port["q_rows"], port["s_rows"])
    route = dict(chunk=port["chunk"], starts=port["starts"], tile=port["query_tile"])
    xt, wt, kpt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(kp)
    out, den, wtd = band_conv_from_lists(lists, *geo, xt, wt, kpt, port["extent"], **route)
    tout, tden = _port_fwd(port, x, w, kp, "bfloat16")
    jout, _ = _jax_fwd(jx, x, w, kp, "bfloat16")
    assert wtd.shape[0] == 2 * port["q_rows"].shape[0] and bool((wtd[len(den):] != 0).any())
    assert np.array_equal(den.numpy(), tden)
    assert rel_l2(out.numpy(), tout) < TWIN_BOUND, rel_l2(out.numpy(), tout)
    assert rel_l2(out.numpy(), jout) < BOUND
    g = torch.zeros((port["q_rows"].shape[0], w.shape[2]))
    g[: cot.shape[0]] = torch.from_numpy(cot)
    dx, dw = band_conv_bwd_from_lists(lists, *geo, xt, wt, kpt, g / den[:, None],
                                      port["extent"], **route)
    tdx, tdw = _grads(port, x, w, kp, cot, "bfloat16")
    jdx, jdw = _jax_grads(jx, x, w, kp, cot, "bfloat16")
    for got, twin, want in ((dx.numpy(), tdx, jdx), (dw.numpy(), tdw, jdw)):
        assert rel_l2(got, twin) < TWIN_BOUND, rel_l2(got, twin)
        assert rel_l2(got, want) < BOUND


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _rz(x):
    """float64 -> float32 rounded toward zero."""
    y = x.astype(np.float32)
    return np.where(np.abs(y) > np.abs(x), np.nextafter(y, np.float32(0)), y)


def _mma_bf16_staged(a, b):
    """``gemm3_kernel``'s bf16 product: each m16n8k16 step adds its 16
    exact products (bf16 x bf16 is exact in f32) to the stage accumulator
    and rounds toward zero; each 32-deep stage is added to the total in
    f32 round-to-nearest."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    k = a.shape[1]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    st = acc.copy()
    for k0 in range(0, k, 16):
        st = _rz(st + a64[:, k0:k0 + 16] @ b64[k0:k0 + 16])
        if (k0 + 16) % 32 == 0 or k0 + 16 >= k:
            acc, st = acc + st, np.zeros_like(st)
    return acc


@pytest.mark.parametrize("product", ["k2_level4", "k4_dw"])
def test_bf16_mma_staging_matches_the_twin(product):
    rng = np.random.default_rng(0 if product == "k2_level4" else 1)
    if product == "k2_level4":  # 64 queries x 15 * 512 -> 64 (weights at the r5 level-4 scale)
        a = (np.abs(rng.normal(size=(64, 15 * 512))) * rng.normal(1.0, 1.0, size=(64, 1))
             ).astype(np.float32) * np.float32(2.0)
        b = (rng.normal(size=(15 * 512, 64)) * 0.004).astype(np.float32)
    else:  # dW = weighted^T gs over 32768 queries, 64 weighted channels x 32 outputs
        a = np.ascontiguousarray((np.abs(rng.normal(size=(32768, 64)))
                                  * rng.normal(1.0, 1.0, size=(32768, 1))).T.astype(np.float32))
        b = (rng.normal(size=(32768, 32)) * 1e-2).astype(np.float32)
    ab, bb = _bf16(a), _bf16(b)
    twin = (torch.from_numpy(ab) @ torch.from_numpy(bb)).numpy()
    got = _mma_bf16_staged(ab, bb)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert rel_l2(got, twin) < TWIN_BOUND, rel_l2(got, twin)
    assert rel_l2(got, exact) < BOUND and rel_l2(twin, exact) > 1e-5  # the rounding is real


def test_linear_bf16_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 96)) * 0.2).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    want = np.asarray(j_apply_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                     jnp.bfloat16))
    lin = Linear(48, 96, torch.Generator().manual_seed(0))
    with torch.no_grad():
        lin.w.copy_(torch.from_numpy(w))
        lin.b.copy_(torch.from_numpy(b))
        f32 = lin(torch.from_numpy(x)).numpy()
    xt = torch.tensor(x, requires_grad=True)
    y = lin(xt, torch.bfloat16)
    got = y.detach().numpy()
    assert got.dtype == np.float32
    assert rel_l2(got, want) < BOUND and not np.array_equal(got, f32)
    # the gradients: bf16 cotangent and products, as JAX transposes bf16 @ bf16
    cot = rng.normal(size=(300, 96)).astype(np.float32)
    (y * torch.from_numpy(cot)).sum().backward()
    jgx, jgw = jax.grad(lambda xx, ww: jnp.sum(j_apply_linear(
        {"w": ww, "b": jnp.asarray(b)}, xx, jnp.bfloat16) * cot), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    assert rel_l2(xt.grad.numpy(), jgx) < BOUND and rel_l2(lin.w.grad.numpy(), jgw) < BOUND


def test_bf16_kernel_route_needs_cuda_and_a_known_panel():
    _, port, x, w, kp, _ = _case()
    kw = dict(port, x=torch.from_numpy(x), weights=torch.from_numpy(w),
              kernel_points=torch.from_numpy(kp))
    with pytest.raises(ValueError, match="CUDA tensor"):
        band_conv(impl="kernel", panel_dtype="bfloat16", lists=object(), **kw)
    with pytest.raises(ValueError, match="panel_dtype"):
        band_conv(panel_dtype="float16", **kw)
    with pytest.raises(ValueError, match="chunk"):  # bf16 rounds at the window's chunks
        band_conv(panel_dtype="bfloat16", **dict(kw, chunk=None))
