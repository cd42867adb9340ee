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
//
// The bf16 panels (band_conv_bf16_launch) replace the same kernel with
// panel_dtype="bfloat16": x and W are cast to bf16 once, both products run
// one BF16 tensor-core product each (band_products.cuh) with f32
// accumulation, the influence weights are rounded to bf16 where they are
// computed, and the density flags sum the bf16 x. Selection, geometry and
// the density stay f32. weighted is rounded where the TPU kernel rounds it,
// once for each chunk of the window a query's list reaches (the chunks of
// `chunk` rows from the tile's window start), and kept for K4 as the bf16
// rows hi and lo of the pieces' f32 sum (band_products.cuh); the second
// product multiplies the [2 nq] rows by W and adds each query's two rows
// (sum_slices_kernel, in f32 round-to-nearest) before dividing by den.

#include <cuda_runtime.h>

#include "band_products.cuh"

// T = float: the f32 panels (3xTF32); T = bf16: x and W already cast to
// bf16 panels, weighted written in bf16
template <typename T>
static int conv_launch(const void* q, const void* s, const T* x, const T* W, const void* kp,
                       const void* lpos, const void* ld2, const void* lcnt, int nq, int ns, int C,
                       int Cout, int KP, float inv_extent, int ldw, int splits, int kc, void* act,
                       T* wtd, void* part, void* out, void* den, const int* starts, int tile,
                       int chunk, float* hilo, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);  // 16-byte row chunks of the products
  if (C < 1 || Cout < 1 || Cout % V || KP < 1 || KP > 16 || ldw < KP * C || ldw % V ||
      splits < 1 || kc < 1 || kc % GBK)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (ns > 0) {
    row_active_kernel<T><<<(unsigned)((ns + 7) / 8), 256, 0, st>>>(x, ns, C, (int*)act);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if ((e = weighted_rows<T>(q, s, x, kp, KP, lpos, ld2, lcnt, (const int*)act, nq, C, ldw,
                            inv_extent, starts, tile, chunk, wtd, (float*)den, st)) != cudaSuccess)
    return (int)e;
  if constexpr (is_bf16<T>) {
    // hilo [2 nq, Cout] = [hi; lo] [2 nq, KP * C] W; out = (hi W + lo W) / den
    if (!hilo) return (int)cudaErrorInvalidValue;
    if ((e = gemm3<T, true, true>(wtd, ldw, W, Cout, hilo, Cout, 2 * nq, Cout, KP * C, splits,
                                  kc, (float*)part, nullptr, st)) != cudaSuccess)
      return (int)e;
    const size_t mn = (size_t)nq * Cout;
    if (mn == 0) return 0;
    sum_slices_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(hilo, 2, nq, Cout,
                                                                    (float*)out, Cout,
                                                                    (const float*)den);
    return (int)cudaGetLastError();
  } else {
    // out [nq, Cout] = weighted [nq, KP * C] W [KP * C, Cout], rows / den
    return (int)gemm3<T, true, true>(wtd, ldw, W, Cout, (float*)out, Cout, nq, Cout, KP * C,
                                     splits, kc, (float*)part, (const float*)den, st);
  }
}

extern "C" int band_conv_launch(const void* q, const void* s, const void* x, const void* W,
                                const void* kp, const void* lpos, const void* ld2,
                                const void* lcnt, int nq, int ns, int C, int Cout, int KP,
                                float inv_extent, int ldw, int splits, int kc, void* act,
                                void* wtd, void* part, void* out, void* den, void* stream) {
  return conv_launch<float>(q, s, (const float*)x, (const float*)W, kp, lpos, ld2, lcnt, nq, ns,
                            C, Cout, KP, inv_extent, ldw, splits, kc, act, (float*)wtd, part,
                            out, den, nullptr, 0, 0, nullptr, (cudaStream_t)stream);
}

// bf16 panels: x [ns, C] and W [KP * C, Cout] (f32) are first cast into
// the bf16 scratch xb and Wb; wtd is [2 nq, ldw] bf16, hilo [2 nq, Cout]
// f32 scratch; starts [nq / tile] the windows' first rows, chunk the rows
// of the TPU kernel's chunks
extern "C" int band_conv_bf16_launch(const void* q, const void* s, const void* x,
                                     const void* W, const void* kp, const void* lpos,
                                     const void* ld2, const void* lcnt, int nq, int ns, int C,
                                     int Cout, int KP, float inv_extent, int ldw, int splits,
                                     int kc, void* act, void* wtd, void* part, void* out,
                                     void* den, const void* starts, int tile, int chunk,
                                     void* hilo, void* xb, void* Wb, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || Cout < 1 || KP < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = to_bf16(x, xb, (size_t)ns * C, st)) != cudaSuccess ||
      (e = to_bf16(W, Wb, (size_t)KP * C * Cout, st)) != cudaSuccess)
    return (int)e;
  return conv_launch<bf16>(q, s, (const bf16*)xb, (const bf16*)Wb, kp, lpos, ld2, lcnt, nq, ns,
                           C, Cout, KP, inv_extent, ldw, splits, kc, act, (bf16*)wtd, part, out,
                           den, (const int*)starts, tile, chunk, (float*)hilo, st);
}
