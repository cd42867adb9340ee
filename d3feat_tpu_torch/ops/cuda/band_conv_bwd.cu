// K4: backward of the band KPConv (threshold selection), for Hopper
// (sm_90a).
//
// Replaces d3feat_tpu/ops/pallas/band_conv.py::_band_conv_bwd_kernel
// (pallas_call in _bwd_call), threshold mode, and its list mode
// (use_thr=False): the same passes over the list mode's lists with the
// list mode's weight (band_lists.cuh, Influence). With gs = g / den (the
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
// panel_dtype="bfloat16" and round where the TPU kernel rounds: gs is cast
// to bf16 once (W comes as K2's bf16 panel), every product is a BF16
// tensor-core product with f32 accumulation, and
//   2. dW = hi^T gs + lo^T gs over the nq queries, K2's bf16 hi and lo rows
//      (hi + lo = the sum of the per-chunk rounded pieces) as two A
//      operands against one stage of gs, each into its own accumulators,
//      added at the end (gemm_bf16);
//   3. V = bf16(gs W^T) [Nq, KP * Cin] on the tensor cores, rounded in the
//      product's epilogue (the TPU kernel rounds gs W[kp]^T before
//      multiplying by the influence weights);
//   4. U: query-major, one warp per query: V[q] is read once (cp.async into
//      shared memory) and for the entries of q's list U[q * lw + j] =
//      sum_kp bf16(w_kp(q, r_j)) V[q, kp] is one m16n8k16 BF16 product
//      (rows the entries, the reduction the 15 kernel points padded to 16,
//      columns Cin), written in f32 (no rounding the TPU kernel does not
//      take);
//   5. dx[r] = sum of U over r's transposed list, support-major, one warp
//      per row, the pairs in ascending order (f32 adds, one owner each).
// A pair moves Cin f32 of U twice (written, read) where gathering V per
// pair read KP * Cin bf16; G and the dx product are not formed.

#include <cuda_runtime.h>

#include "band_products.cuh"

#define RPB 8   // support rows per CTA of the gather, one warp each
#define KPM 16  // kernel points a lane may hold: KP <= KPM

// f32 G: NS channel slots per lane, one warp covers 32 * NS channels of gs
template <int NS, bool LIST>
__global__ void __launch_bounds__(RPB * 32)
bwd_gather_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                  const float* __restrict__ gs, const float* __restrict__ kp,
                  const float* __restrict__ ld2, const int* __restrict__ row_ptr,
                  const int* __restrict__ pairs, int lw, int ns, int Cout, int KP,
                  Influence inf, float* __restrict__ G) {
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
  const int lsh = list_shift(lw);
  const int pend = row_ptr[r + 1];
  for (int p = row_ptr[r]; p < pend; ++p) {
    const int f = pairs[p];
    const int qi = f >> lsh;
    const float w =
        lane < KP ? influence<LIST>(inf, entry_d2<LIST>(ld2, f), sr, q[qi], kx, ky, kz, kk) : 0.f;
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

// bf16 U, one warp per query, UQ warps a CTA, the list in segments of LSEG
// entries (each entry's row of U is its own: the segments are independent):
// the influence weights of the segment's entries (rounded to bf16; kernel
// points past KP and entries past the count zero) into shared memory [16
// kernel points x LSEG entries], the A fragments (entries by kernel
// points) by ldmatrix.trans; then per pass of 64 channels V[q] [16 x 64]
// (kernel points past KP zero) by cp.async, the B fragments by
// ldmatrix.trans, and one MMA per 16 entries and 8 channels. U [nq * lw,
// C] f32, rows q * lw + j for j < lcnt[q]. WIDE: lists wider than LSEG
// (without it, one segment, unrolled as a straight-line body).
#define UQ 8
#define UW 64            // channels of one pass
#define ULD (UW + 8)     // padded shared rows: 16-byte aligned, conflict-free
#define WLDU (LSEG + 8)
template <bool LIST, bool WIDE>
__global__ void __launch_bounds__(UQ * 32)
bwd_u_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
             const bf16* __restrict__ V, const float* __restrict__ kp, int KP,
             const int* __restrict__ lpos, const float* __restrict__ ld2,
             const int* __restrict__ lcnt, int lw, int nq, int C, Influence inf,
             float* __restrict__ U) {
  __shared__ __align__(16) bf16 w_all[UQ][16 * WLDU];
  __shared__ __align__(16) bf16 v_all[UQ][16 * ULD];
  __shared__ float kps[48];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (threadIdx.x < 3 * KP) kps[threadIdx.x] = kp[threadIdx.x];
  __syncthreads();
  const int qi = blockIdx.x * UQ + warp;
  if (qi >= nq) return;
  const int n = lcnt[qi];
  if (n == 0) return;
  bf16* wsm = w_all[warp];
  bf16* vs = v_all[warp];
  const float4 qq = q[qi];
  const bf16* vq = V + (size_t)qi * KP * C;
  const int i8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
  for (int s0 = 0; s0 < (WIDE ? n : 1); s0 += LSEG) {
    const int sn = min(LSEG, n - s0);  // the segment's entries s0 + [0, sn)
    const size_t e0 = (size_t)qi * lw + s0;
#pragma unroll
    for (int h = 0; h < LSEG / 32; ++h) {
      const int j = lane + 32 * h;
      const bool v = j < sn;
      const float4 sr = s[v ? lpos[e0 + j] : 0];
      const float d2 = v ? entry_d2<LIST>(ld2, e0 + j) : 0.f;
      for (int k = 0; k < 16; ++k) {
        float w = 0.f;
        if (v && k < KP) {
          const float kx = kps[3 * k], ky = kps[3 * k + 1], kz = kps[3 * k + 2];
          w = influence<LIST>(inf, d2, sr, qq, kx, ky, kz, dot3(kx, ky, kz, kx, ky, kz));
        }
        wsm[k * WLDU + j] = __float2bfloat16_rn(w);
      }
    }
    __syncwarp();
    const int nmt = (sn + 15) / 16;
    unsigned af[LSEG / 16][4];  // A: entries (rows) by kernel points (reduction)
#pragma unroll
    for (int mt = 0; mt < LSEG / 16; ++mt)
      if (mt < nmt) ldsm_x4_t(af[mt], wsm + (i8 + 8 * h2) * WLDU + 16 * mt + 8 * h1);
    float* uq = U + e0 * C;
    for (int c0 = 0; c0 < C; c0 += UW) {
      for (int i = lane; i < 16 * (UW / 8); i += 32) {  // V[q, kp, c0 .. c0 + UW)
        const int k = i / (UW / 8), c = c0 + 8 * (i % (UW / 8));
        const bool v = k < KP && c < C;
        cp_async16z(vs + k * ULD + 8 * (i % (UW / 8)), v ? vq + (size_t)k * C + c : V, v);
      }
      cp_async_wait_all();
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < UW / 8; nt += 2) {
        if (c0 + nt * 8 >= C) break;
        unsigned b[4];  // kernel points by channels c0 + nt * 8 .. + 16
        ldsm_x4_t(b, vs + (i8 + 8 * h1) * ULD + nt * 8 + 8 * h2);
#pragma unroll
        for (int mt = 0; mt < LSEG / 16; ++mt) {
          if (mt >= nmt) break;
#pragma unroll
          for (int hn = 0; hn < 2; ++hn) {
            const int c = c0 + (nt + hn) * 8 + 2 * t;
            if (c >= C) continue;
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d, af[mt], b + 2 * hn);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = 16 * mt + g + 8 * h;
              if (j < sn)
                *reinterpret_cast<float2*>(uq + (size_t)j * C + c) =
                    make_float2(d[2 * h], d[2 * h + 1]);
            }
          }
        }
      }
      __syncwarp();  // the next pass overwrites V's stage (the next segment, the weights)
    }
  }
}

// bf16 dx[r] = sum of U over r's transposed list, pairs in ascending order,
// one warp per support row, four channels a lane (C % 4 == 0); rows that
// no list names get 0
__global__ void __launch_bounds__(RPB * 32)
bwd_dx_sum_kernel(const float* __restrict__ U, const int* __restrict__ row_ptr,
                  const int* __restrict__ pairs, int ns, int C, float* __restrict__ dx) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RPB + (threadIdx.x >> 5);
  if (r >= ns) return;
  const int pbeg = row_ptr[r], pend = row_ptr[r + 1];
  for (int c = 4 * lane; c < C; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = pbeg; p < pend; ++p) {
      const float4 u = *reinterpret_cast<const float4*>(U + (size_t)pairs[p] * C + c);
      acc.x = __fadd_rn(acc.x, u.x);
      acc.y = __fadd_rn(acc.y, u.y);
      acc.z = __fadd_rn(acc.z, u.z);
      acc.w = __fadd_rn(acc.w, u.w);
    }
    *reinterpret_cast<float4*>(dx + (size_t)r * C + c) = acc;
  }
}

// the f32 panels (3xTF32): G [ns, KP * Cout] f32 scratch
static int bwd_launch(const void* q, const void* s, const float* W, const void* kp,
                      const float* gs, const void* ld2, const void* row_ptr, const void* pairs,
                      int lw, int nq, int ns, int C, int Cout, int KP, Influence inf, int ldw,
                      int splits, int kc, int dx_splits, int dx_kc, const float* wtd, void* part,
                      void* dW, float* G, void* dx, cudaStream_t st) {
  constexpr int V = 4;  // 16-byte row chunks of the products
  if (C < 1 || Cout < 1 || Cout % V || KP < 1 || KP > KPM || ldw < KP * C || ldw % V ||
      splits < 1 || kc < 1 || kc % GBK || dx_splits < 1 || dx_kc < 1 || dx_kc % GBK ||
      !list_width_ok(lw) || (dx && (!G || !row_ptr || !pairs)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  // dW [KP * C, Cout] = weighted^T gs, reduced over the nq queries
  if ((e = gemm3<float, false, true>(wtd, ldw, gs, Cout, (float*)dW, Cout, KP * C, Cout, nq,
                                     splits, kc, (float*)part, nullptr, st)) != cudaSuccess)
    return (int)e;
  if (!dx || ns == 0) return 0;
  // G [ns, KP * Cout]
#define G_ARGS                                                                              \
  (const float4*)q, (const float4*)s, gs, (const float*)kp, (const float*)ld2,               \
      (const int*)row_ptr, (const int*)pairs, lw, ns, Cout, KP, inf, G
  const unsigned rows = (unsigned)((ns + RPB - 1) / RPB);
  const dim3 wide(rows, (Cout + 127) / 128);
  if (inf.list) {
    if (Cout <= 32) bwd_gather_kernel<1, true><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else if (Cout <= 64) bwd_gather_kernel<2, true><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else bwd_gather_kernel<4, true><<<wide, RPB * 32, 0, st>>>(G_ARGS);
  } else {
    if (Cout <= 32) bwd_gather_kernel<1, false><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else if (Cout <= 64) bwd_gather_kernel<2, false><<<rows, RPB * 32, 0, st>>>(G_ARGS);
    else bwd_gather_kernel<4, false><<<wide, RPB * 32, 0, st>>>(G_ARGS);
  }
#undef G_ARGS
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dx [ns, C] = G W^T: the reduction index k * Cout + co reads W[k][c][co];
  // row tiles that no list names (padding, shadow rows) are written as zeros
  return (int)gemm3<float, true, false>(G, KP * Cout, W, Cout, (float*)dx, C, ns, C, KP * Cout,
                                        dx_splits, dx_kc, (float*)part, nullptr, st, Cout,
                                        (long long)C * Cout, (const int*)row_ptr);
}

extern "C" int band_conv_bwd_launch(const void* q, const void* s, const void* W, const void* kp,
                                    const void* gs, const void* ld2, const void* row_ptr,
                                    const void* pairs, int nq, int ns, int C, int Cout, int KP,
                                    int lw, float inv_extent, float extent, int list_mode,
                                    int ldw, int splits, int kc, int dx_splits, int dx_kc,
                                    const void* wtd, void* part, void* dW, void* G, void* dx,
                                    void* stream) {
  return bwd_launch(q, s, (const float*)W, kp, (const float*)gs, ld2, row_ptr, pairs, lw, nq, ns,
                    C, Cout, KP, Influence{inv_extent, extent, list_mode}, ldw, splits, kc,
                    dx_splits, dx_kc, (const float*)wtd, part, dW, (float*)G, dx,
                    (cudaStream_t)stream);
}

// bf16 panels: gs [nq, Cout] (f32) is cast once into the bf16 scratch gsb;
// wtd is K2's [2 nq, ldw] bf16 rows (hi then lo), part [splits, 2, KP * C,
// Cout] when splits > 1. For dx (C % 8 == 0): Wb, K2's bf16 panel of W
// [KP * C, Cout]; the lists lpos / lcnt and their transpose row_ptr /
// pairs; V [nq, KP * C] bf16 and U [nq * lw, C] f32 scratch.
extern "C" int band_conv_bwd_bf16_launch(const void* q, const void* s, const void* Wb,
                                         const void* kp, const void* gs, const void* lpos,
                                         const void* ld2, const void* lcnt, const void* row_ptr,
                                         const void* pairs, int nq, int ns, int C, int Cout,
                                         int KP, int lw, float inv_extent, float extent,
                                         int list_mode,
                                         int ldw, int splits, int kc, const void* wtd,
                                         void* part, void* dW, void* V, void* U, void* dx,
                                         void* gsb, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || Cout < 1 || Cout % 8 || KP < 1 || KP > KPM || ldw < KP * C || ldw % 8 ||
      splits < 1 || kc < 1 || kc % GBK || !list_width_ok(lw) ||
      (dx && (C % 8 || !Wb || !lpos || !lcnt || !row_ptr || !pairs || !V || !U)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if ((e = to_bf16(gs, gsb, (size_t)nq * Cout, st)) != cudaSuccess) return (int)e;
  const bf16* g = (const bf16*)gsb;
  // dW [KP * C, Cout] = hi^T gs + lo^T gs, reduced over the nq queries
  if ((e = gemm_bf16<false, true, true, float>((const bf16*)wtd, (long long)nq * ldw, ldw, g,
                                               Cout, (float*)dW, Cout, KP * C, Cout, nq, splits,
                                               kc, (float*)part, nullptr, st)) != cudaSuccess)
    return (int)e;
  if (!dx || ns == 0) return 0;
  if (nq > 0) {
    // V [nq, KP * C] = bf16(gs W^T): B(k = co, n = kp * C + c) = W[kp][c][co]
    if ((e = gemm_bf16<true, false, false, bf16>(g, 0, Cout, (const bf16*)Wb, Cout, (bf16*)V,
                                                 KP * C, nq, KP * C, Cout, 1,
                                                 (Cout + GBK - 1) / GBK * GBK, nullptr, nullptr,
                                                 st)) != cudaSuccess)
      return (int)e;
    const unsigned ctas = (unsigned)((nq + UQ - 1) / UQ);
#define U_ARGS                                                                          \
  (const float4*)q, (const float4*)s, (const bf16*)V, (const float*)kp, KP,              \
      (const int*)lpos, (const float*)ld2, (const int*)lcnt, lw, nq, C,                  \
      Influence{inv_extent, extent, list_mode}, (float*)U
    const bool wide = lw > LSEG;
    if (list_mode && wide) bwd_u_kernel<true, true><<<ctas, UQ * 32, 0, st>>>(U_ARGS);
    else if (list_mode) bwd_u_kernel<true, false><<<ctas, UQ * 32, 0, st>>>(U_ARGS);
    else if (wide) bwd_u_kernel<false, true><<<ctas, UQ * 32, 0, st>>>(U_ARGS);
    else bwd_u_kernel<false, false><<<ctas, UQ * 32, 0, st>>>(U_ARGS);
#undef U_ARGS
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  bwd_dx_sum_kernel<<<(unsigned)((ns + RPB - 1) / RPB), RPB * 32, 0, st>>>(
      (const float*)U, (const int*)row_ptr, (const int*)pairs, ns, C, (float*)dx);
  return (int)cudaGetLastError();
}
