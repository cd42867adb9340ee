// K2: rigid KPConv over sorted support bands, threshold selection, for
// Hopper (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/band_conv.py::_band_conv_kernel
// (pallas_call in band_conv), forward, threshold mode. For each sorted
// query q, over the rows its list selects (band_lists.cu: the rows of its
// tile's window with d2 < thr[q] or d2 == thr[q] and position <= ptie[q],
// which reproduces q's K1 list), per kernel point kp
//     w   = max(1 - sqrt(max(d2 + a + b, 0)) / extent, 0)
//           (a = -2 s.k, b = 2 q.k + |k|^2, the reference's expansion)
//     y  += (w^T x_list) W[kp]
// and den = max(#listed rows with row-sum > 0, 1); out = y / den.
//
// The TPU kernel multiplies dense [T x band] panels and redoes the
// selection in every conv; here the lists are built once per search (the
// list stage, shared by every conv of the search and by K4), and the
// conv is three passes over them (band_products.cuh):
//   1. row flags: act[r] = (sum_c x[r][c] > 0), for the density;
//   2. the first product, per query: weighted [Nq, KP * Cin] =
//      [16 x list] influence weights by the [list x Cin] gathered rows on
//      the tensor cores (3xTF32), each gathered row read once for all 15
//      kernel points; the density from the flags;
//   3. the second product: out = weighted [Nq, KP * Cin] W [KP * Cin, Cout]
//      / den on the tensor cores (3xTF32), 64 x 64 tiles staged through
//      shared memory by cp.async, double-buffered; the reduction split
//      into fixed slices where the tiles alone would not fill the card.
// weighted is kept for K4 (dW = weighted^T gs). Bound: the second product
// at the deep levels (3 TF32 products per f32 product), the gathers of the
// first product and the weights at level 0.

#include <cuda_runtime.h>

#include "band_products.cuh"

extern "C" int band_conv_launch(const void* q, const void* s, const void* x, const void* W,
                                const void* kp, const void* lpos, const void* ld2,
                                const void* lcnt, int nq, int ns, int C, int Cout, int KP,
                                float inv_extent, int ldw, int splits, int kc, void* act,
                                void* wtd, void* part, void* out, void* den, void* stream) {
  if (C < 1 || Cout < 1 || Cout % 4 || KP < 1 || KP > 16 || ldw < KP * C || ldw % 4 ||
      splits < 1 || kc < 1 || kc % GBK)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (ns > 0) {
    row_active_kernel<<<(unsigned)((ns + 7) / 8), 256, 0, st>>>((const float*)x, ns, C,
                                                                 (int*)act);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if ((e = weighted_rows(q, s, x, kp, KP, lpos, ld2, lcnt, (const int*)act, nq, C, ldw,
                         inv_extent, (float*)wtd, (float*)den, st)) != cudaSuccess)
    return (int)e;
  // out [nq, Cout] = weighted [nq, KP * C] W [KP * C, Cout], rows / den
  return (int)gemm3<true, true>((const float*)wtd, ldw, (const float*)W, Cout, (float*)out,
                                Cout, nq, Cout, KP * C, splits, kc, (float*)part,
                                (const float*)den, st);
}
