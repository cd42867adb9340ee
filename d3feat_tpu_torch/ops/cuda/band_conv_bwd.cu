// K4: backward of the band KPConv (threshold selection), for Hopper
// (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/band_conv.py::_band_conv_bwd_kernel
// (pallas_call in _bwd_call), threshold mode. With gs = g / den (the
// density-scaled cotangent, formed by the caller as the TPU path forms it
// outside its kernel) and w_kp(q, r) the influence weights of the rows
// listed for q (the list stage's lists and band_lists.cuh's weights, bit
// for bit K2's):
//     dW[kp] = sum_q weighted_kp[q]^T gs[q],
//              weighted_kp[q] = sum_{r in list(q)} w_kp(q, r) x[r]
//     dx[r]  = sum_{q : r in list(q)} sum_kp w_kp(q, r) W[kp] gs[q]
//            = sum_kp W[kp] G[r, kp],  G[r, kp] = sum_{q : r in list(q)} w_kp(q, r) gs[q]
// The TPU kernel walks its grid in order, carrying dW in one accumulator
// and reading-modifying-writing the dx rows of overlapping windows. Here
// CTAs run concurrently, so every sum has one owner and a fixed order
// (the result is the same from run to run):
//   1. weighted [Nq, KP * Cin]: K2's first product, kept by the forward;
//   2. dW = weighted^T gs on the tensor cores (3xTF32), the query range
//      cut into fixed slices whose partial sums are added in slice order;
//   3. G [Ns, KP * Cout]: support-major over the transposed lists (for each
//      support row r, the (query, entry) pairs that list it, in ascending
//      query order), one warp per row and up to 128 channels of gs: the
//      lanes k < KP compute w_k(q, r), and each lane adds w_k gs[q, c] into
//      its channels (FMA, pairs in order). No threshold test is redone, and
//      a pair reads Cout values of gs, where gathering gW = gs W^T per pair
//      would read KP * Cin;
//   4. dx = G W^T on the tensor cores, the same product routine, skipping
//      the row tiles that no list names.
// Bound: the two dense products (3 TF32 products per f32 product) at the
// deep levels; the gs rows read per listed pair at level 0.
//
// The bf16 panels (band_conv_bwd_bf16_launch) replace the same kernel with
// panel_dtype="bfloat16" and round where the TPU kernel rounds: gs and W
// are cast to bf16 once, every product is one BF16 tensor-core product
// with f32 accumulation (or an FMA of two bf16 values, exact, into f32),
// and
//   2. dW = [hi; lo]^T [gs; gs] over the 2 nq rows of K2's bf16 weighted
//      rows (hi + lo = the sum of the per-chunk rounded pieces);
//   3. V = bf16(gs W^T) [Nq, KP * Cin] on the tensor cores (the TPU kernel
//      rounds gs W[kp]^T before multiplying by the influence weights);
//   4. dx[r] = sum_{(q, entry) listing r} sum_kp bf16(w_kp(q, r)) V[q, kp]
//      over the transposed lists, one warp per row and up to 128 channels
//      (FMA, pairs in order, kernel points in order).
// This reads KP * Cin values of V per pair where the f32 route reads Cout
// values of gs; G and the dx product are not formed.

#include <cuda_runtime.h>

#include "band_products.cuh"

#define RPB 8   // support rows per CTA of the gather, one warp each
#define KPM 16  // kernel points a lane may hold: KP <= KPM

// f32 G: NS channel slots per lane, one warp covers 32 * NS channels of gs
template <int NS>
__global__ void __launch_bounds__(RPB * 32)
bwd_gather_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                  const float* __restrict__ gs, const float* __restrict__ kp,
                  const float* __restrict__ ld2, const int* __restrict__ row_ptr,
                  const int* __restrict__ pairs, int ns, int Cout, int KP, float inv_extent,
                  float* __restrict__ G) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  const int c0 = blockIdx.y * 32 * NS;
  const float4 sr = s[r];
  float kx = 0.f, ky = 0.f, kz = 0.f, kk = 0.f;  // lane k < KP: kernel point k
  if (lane < KP) {
    kx = kp[3 * lane];
    ky = kp[3 * lane + 1];
    kz = kp[3 * lane + 2];
    kk = dot3(kx, ky, kz, kx, ky, kz);
  }
  float acc[KPM][NS];
#pragma unroll
  for (int k = 0; k < KPM; ++k)
#pragma unroll
    for (int i = 0; i < NS; ++i) acc[k][i] = 0.f;
  const int pend = row_ptr[r + 1];
  for (int p = row_ptr[r]; p < pend; ++p) {
    const int f = pairs[p];
    const int qi = f / LCAP;
    const float w = lane < KP ? kp_weight(ld2[f], sr, q[qi], kx, ky, kz, kk, inv_extent) : 0.f;
    const float* g = gs + (size_t)qi * Cout;
    float gv[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = c0 + lane + 32 * i;
      gv[i] = c < Cout ? g[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < KPM; ++k) {
      if (k < KP) {
        const float wk = __shfl_sync(0xffffffffu, w, k);
#pragma unroll
        for (int i = 0; i < NS; ++i) acc[k][i] = __fmaf_rn(wk, gv[i], acc[k][i]);
      }
    }
  }
  float* out = G + (size_t)r * KP * Cout;
#pragma unroll
  for (int k = 0; k < KPM; ++k) {
    if (k < KP) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < Cout) out[(size_t)k * Cout + c] = acc[k][i];
      }
    }
  }
}

// bf16 dx from V = bf16(gs W^T) [nq, KP * C]: NS channel slots per lane,
// one warp covers 32 * NS channels of dx; rows that no list names get 0
template <int NS>
__global__ void __launch_bounds__(RPB * 32)
bwd_dx_gather_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                     const bf16* __restrict__ V, const float* __restrict__ kp,
                     const float* __restrict__ ld2, const int* __restrict__ row_ptr,
                     const int* __restrict__ pairs, int ns, int C, int KP, float inv_extent,
                     float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  const int c0 = blockIdx.y * 32 * NS;
  const float4 sr = s[r];
  float kx = 0.f, ky = 0.f, kz = 0.f, kk = 0.f;  // lane k < KP: kernel point k
  if (lane < KP) {
    kx = kp[3 * lane];
    ky = kp[3 * lane + 1];
    kz = kp[3 * lane + 2];
    kk = dot3(kx, ky, kz, kx, ky, kz);
  }
  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.f;
  const int pend = row_ptr[r + 1];
  for (int p = row_ptr[r]; p < pend; ++p) {
    const int f = pairs[p];
    const int qi = f / LCAP;
    const float w =
        lane < KP ? panel_round<bf16>(kp_weight(ld2[f], sr, q[qi], kx, ky, kz, kk, inv_extent))
                  : 0.f;
    const bf16* v = V + (size_t)qi * KP * C;
#pragma unroll
    for (int k = 0; k < KPM; ++k) {
      if (k < KP) {
        const float wk = __shfl_sync(0xffffffffu, w, k);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int c = c0 + lane + 32 * i;
          if (c < C) acc[i] = __fmaf_rn(wk, to_f32(v[k * C + c]), acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int c = c0 + lane + 32 * i;
    if (c < C) dx[(size_t)r * C + c] = acc[i];
  }
}

// T = float: the f32 panels (3xTF32), G [ns, KP * Cout] f32; T = bf16: gs
// ([2 nq, Cout], gs twice), W and the weighted rows ([2 nq, ldw], hi and
// lo) already bf16 panels, G the V rows [nq, KP * C] in bf16 and vf their
// f32 scratch
template <typename T>
static int bwd_launch(const void* q, const void* s, const T* W, const void* kp, const T* gs,
                      const void* ld2, const void* row_ptr, const void* pairs, int nq, int ns,
                      int C, int Cout, int KP, float inv_extent, int ldw, int splits, int kc,
                      int dx_splits, int dx_kc, const T* wtd, void* part, void* dW, T* G,
                      void* dx, float* vf, cudaStream_t st) {
  constexpr bool BF = is_bf16<T>;
  constexpr int V = 16 / sizeof(T);  // 16-byte row chunks of the products
  if (C < 1 || Cout < 1 || Cout % V || KP < 1 || KP > KPM || ldw < KP * C || ldw % V ||
      splits < 1 || kc < 1 || kc % GBK || dx_splits < 1 || dx_kc < 1 || dx_kc % GBK ||
      (dx && (!G || !row_ptr || !pairs || (BF && !vf))))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  // dW [KP * C, Cout] = weighted^T gs, reduced over the nq queries (bf16:
  // over the 2 nq rows hi, lo against gs, gs)
  if ((e = gemm3<T, false, true>(wtd, ldw, gs, Cout, (float*)dW, Cout, KP * C, Cout,
                                 BF ? 2 * nq : nq, splits, kc, (float*)part, nullptr, st)) !=
      cudaSuccess)
    return (int)e;
  if (!dx || ns == 0) return 0;
  if constexpr (BF) {
    // V [nq, KP * C] = bf16(gs W^T): B(k = co, n = kp * C + c) = W[kp][c][co]
    if (nq > 0) {
      if ((e = gemm3<T, true, false>(gs, Cout, W, Cout, vf, KP * C, nq, KP * C, Cout, 1,
                                     (Cout + GBK - 1) / GBK * GBK, nullptr, nullptr, st)) !=
              cudaSuccess ||
          (e = to_bf16(vf, G, (size_t)nq * KP * C, st)) != cudaSuccess)
        return (int)e;
    }
#define V_ARGS                                                                              \
  (const float4*)q, (const float4*)s, G, (const float*)kp, (const float*)ld2,                \
      (const int*)row_ptr, (const int*)pairs, ns, C, KP, inv_extent, (float*)dx
    const unsigned rows = (unsigned)((ns + RPB - 1) / RPB);
    if (C <= 32) bwd_dx_gather_kernel<1><<<rows, RPB * 32, 0, st>>>(V_ARGS);
    else if (C <= 64) bwd_dx_gather_kernel<2><<<rows, RPB * 32, 0, st>>>(V_ARGS);
    else bwd_dx_gather_kernel<4><<<dim3(rows, (C + 127) / 128), RPB * 32, 0, st>>>(V_ARGS);
#undef V_ARGS
    return (int)cudaGetLastError();
  } else {
    // G [ns, KP * Cout]
#define G_ARGS                                                                              \
  (const float4*)q, (const float4*)s, gs, (const float*)kp, (const float*)ld2,               \
      (const int*)row_ptr, (const int*)pairs, ns, Cout, KP, inv_extent, G
    const unsigned rows = (unsigned)((ns + RPB - 1) / RPB);
    if (Cout <= 32) bwd_gather_kernel<1><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else if (Cout <= 64) bwd_gather_kernel<2><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else bwd_gather_kernel<4><<<dim3(rows, (Cout + 127) / 128), RPB * 32, 0, st>>>(G_ARGS);
#undef G_ARGS
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // dx [ns, C] = G W^T: the reduction index k * Cout + co reads W[k][c][co];
    // row tiles that no list names (padding, shadow rows) are written as zeros
    return (int)gemm3<T, true, false>(G, KP * Cout, W, Cout, (float*)dx, C, ns, C, KP * Cout,
                                      dx_splits, dx_kc, (float*)part, nullptr, st, Cout,
                                      (long long)C * Cout, (const int*)row_ptr);
  }
}

extern "C" int band_conv_bwd_launch(const void* q, const void* s, const void* W, const void* kp,
                                    const void* gs, const void* ld2, const void* row_ptr,
                                    const void* pairs, int nq, int ns, int C, int Cout, int KP,
                                    float inv_extent, int ldw, int splits, int kc, int dx_splits,
                                    int dx_kc, const void* wtd, void* part, void* dW, void* G,
                                    void* dx, void* stream) {
  return bwd_launch<float>(q, s, (const float*)W, kp, (const float*)gs, ld2, row_ptr, pairs, nq,
                           ns, C, Cout, KP, inv_extent, ldw, splits, kc, dx_splits, dx_kc,
                           (const float*)wtd, part, dW, (float*)G, dx, nullptr,
                           (cudaStream_t)stream);
}

// bf16 panels: gs [nq, Cout] is cast twice into the bf16 scratch gsb
// [2 nq, Cout] and, for dx, W [KP * C, Cout] (f32) into Wb; wtd is K2's
// [2 nq, ldw] bf16 rows; for dx, G holds V [nq, KP * C] in bf16 and vf
// [nq, KP * C] f32 is its scratch
extern "C" int band_conv_bwd_bf16_launch(const void* q, const void* s, const void* W,
                                         const void* kp, const void* gs, const void* ld2,
                                         const void* row_ptr, const void* pairs, int nq, int ns,
                                         int C, int Cout, int KP, float inv_extent, int ldw,
                                         int splits, int kc, int dx_splits, int dx_kc,
                                         const void* wtd, void* part, void* dW, void* G,
                                         void* dx, void* gsb, void* Wb, void* vf,
                                         void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || Cout < 1 || KP < 1 || (dx && (!Wb || !vf))) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const size_t n = (size_t)nq * Cout;
  if ((e = to_bf16(gs, gsb, n, st)) != cudaSuccess ||
      (e = to_bf16(gs, (bf16*)gsb + n, n, st)) != cudaSuccess)
    return (int)e;
  if (dx && (e = to_bf16(W, Wb, (size_t)KP * C * Cout, st)) != cudaSuccess) return (int)e;
  return bwd_launch<bf16>(q, s, (const bf16*)Wb, kp, (const bf16*)gsb, ld2, row_ptr, pairs, nq,
                          ns, C, Cout, KP, inv_extent, ldw, splits, kc, dx_splits, dx_kc,
                          (const bf16*)wtd, part, dW, (bf16*)G, dx, (float*)vf, st);
}
