// The products of K2 (band_conv.cu) and K4 (band_conv_bwd.cu) over the
// per-query lists of the list stage (band_lists.cu):
//
//   weighted[q][kp * C + c] = sum_j w_kp(q, j) x[lpos[q][j]][c]
//       the first product, per query: [16 kernel points (15 padded to one
//       m16 tile) x list] by [list x C gathered rows];
//   gemm3: C = A B over fixed reduction slices, for the second product
//       y = weighted W and for K4's dW = weighted^T gs and dx = G W^T (bf16
//       panels: V = gs W^T) (named for its 3xTF32 products; with bf16
//       panels one BF16 product).
//
// Every kernel is templated on the panel type T of its operands:
// - T = float: the products run on the tensor cores as 3xTF32: every f32
//   operand a is split into a_hi = tf32(a) and a_lo = tf32(a - a_hi)
//   (cvt.rna, round to nearest), and each product is a_lo b_hi + a_hi b_lo
//   + a_hi b_hi, three mma.sync.m16n8k8 TF32 steps accumulated in f32 in
//   that fixed order, which keeps about f32 accuracy (plain TF32 keeps
//   about three digits);
// - T = __nv_bfloat16 (the bf16 panels of compute_dtype="bfloat16"): the
//   operands are bf16 in memory (the influence weights are rounded to
//   nearest where they are computed), one mma.sync.m16n8k16 BF16 step per
//   product, accumulated in f32; outputs that are panels of a later
//   product are written in bf16, rounded to nearest. The first product
//   rounds where the TPU kernel rounds: the TPU kernel walks the tile's
//   window in chunks of `chunk` rows and rounds each chunk's weighted
//   rows to bf16 before multiplying them by W, so here each query's list
//   (ascending positions) is cut at the window's chunk boundaries, each
//   piece's sum is rounded to bf16, and the pieces are added in f32:
//   S = sum_c bf16(weighted_c). S is written as two bf16 rows, hi =
//   bf16(S) and lo = bf16(S - hi) (hi + lo = S to about 2^-17 relative),
//   so that S W = hi W + lo W stays two exact BF16 products.
// The tensor cores' own additions truncate, so gemm3 sums each 32-deep
// stage in fresh accumulators and adds those in f32 round-to-nearest.
// (The first product of a single input feature is FP32 FMA instead, on
// the panel's values.) Every output has one owner and a fixed reduction
// order, so results are the same from run to run. Fragment layouts
// (cute/atom/mma_traits_sm80.hpp), with g = lane / 4, t = lane % 4:
// SM80_16x8x8_F32TF32TF32F32_TN
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
// SM80_16x8x16_F32BF16BF16F32_TN (two bf16 a register, the lower index in
// the low half)
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
// and for both
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "band_lists.cuh"

typedef __nv_bfloat16 bf16;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (is_bf16<T>) return __float2bfloat16_rn(v);
  else return v;
}

// v rounded to the panel type T, as a float
template <typename T>
__device__ __forceinline__ float panel_round(float v) {
  return to_f32(from_f32<T>(v));
}

// two bf16 values in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// two consecutive bf16 values (4-byte aligned) as one register
__device__ __forceinline__ unsigned load_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: small terms first, then the large one
__device__ __forceinline__ void mma3(float* d, const unsigned* ah, const unsigned* al,
                                     const unsigned* bh, const unsigned* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// dst[i] = bf16(src[i]), rounded to nearest: the bf16 panels of x, W, gs
__global__ void to_bf16_kernel(const float* __restrict__ src, bf16* __restrict__ dst, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

static inline cudaError_t to_bf16(const void* src, void* dst, size_t n, cudaStream_t st) {
  if (n == 0) return cudaSuccess;
  to_bf16_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>((const float*)src, (bf16*)dst, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// density: act[r] = (sum_c x[r][c] > 0) over the panel's values (bf16 x:
// its rounded values, as the TPU kernel sums its bf16 panel), the sum by
// lanes then a shuffle tree
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
row_active_kernel(const T* __restrict__ x, int ns, int C, int* __restrict__ act) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= ns) return;
  const T* xr = x + (size_t)r * C;
  float part = 0.f;
  for (int c = lane; c < C; c += 32) part = __fadd_rn(part, to_f32(xr[c]));
  for (int o = 16; o; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (lane == 0) act[r] = part > 0.f;
}

// den[q] = max(#listed rows of q with act, 1), by one warp
__device__ __forceinline__ void list_density(const int* __restrict__ lp, int n,
                                             const int* __restrict__ act, float* den) {
  const int lane = threadIdx.x & 31;
  int a = 0;
  for (int j = lane; j < n; j += 32) a += act[lp[j]];
  for (int o = 16; o; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  if (lane == 0) *den = fmaxf((float)a, 1.f);
}

// ---------------------------------------------------------------------------
// first product: one warp per query, the list in k-steps of 8 rows
// ---------------------------------------------------------------------------

// NTL n-tiles of 8 channels per pass over the list, in k-steps of KS list
// rows (8 in TF32, 16 in BF16). Each lane computes the influence weights of
// its A-fragment entries (kernel points g, g + 8 and its R = KS / 4 list
// rows of the k-step: t, t + 4 in TF32; 2t, 2t + 1, 2t + 8, 2t + 9 in BF16)
// and loads its B-fragment entries straight from the gathered rows.
template <typename T, int NTL>
__global__ void __launch_bounds__(256)
weighted_mma_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                    const T* __restrict__ x, const float* __restrict__ kp, int KP,
                    const int* __restrict__ lpos, const float* __restrict__ ld2,
                    const int* __restrict__ lcnt, const int* __restrict__ act, int nq, int C,
                    int ldw, float inv_extent, const int* __restrict__ starts, int tile,
                    int chunk, T* __restrict__ wtd, float* __restrict__ den) {
  constexpr bool BF = is_bf16<T>;
  constexpr int KS = BF ? 16 : 8, R = KS / 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qi = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (qi >= nq) return;
  const int n = lcnt[qi];
  const float4 qq = q[qi];
  const int* lp = lpos + (size_t)qi * LCAP;
  const float* ldd = ld2 + (size_t)qi * LCAP;
  T* out = wtd + (size_t)qi * ldw;
  T* out_lo = wtd + (size_t)(nq + qi) * ldw;  // bf16: the lo rows
  const int ws = BF ? starts[qi / tile] : 0;   // bf16: the window's first row
  const bool has0 = g < KP, has1 = g + 8 < KP;
  float k0x = 0.f, k0y = 0.f, k0z = 0.f, k1x = 0.f, k1y = 0.f, k1z = 0.f;
  if (has0) { k0x = kp[3 * g]; k0y = kp[3 * g + 1]; k0z = kp[3 * g + 2]; }
  if (has1) { k1x = kp[3 * g + 24]; k1y = kp[3 * g + 25]; k1z = kp[3 * g + 26]; }
  const float kk0 = dot3(k0x, k0y, k0z, k0x, k0y, k0z);
  const float kk1 = dot3(k1x, k1y, k1z, k1x, k1y, k1z);

  for (int c0 = 0; c0 < C; c0 += 8 * NTL) {
    float acc[NTL][4], tot[NTL][4];  // tot (bf16): the sum of the rounded pieces
#pragma unroll
    for (int i = 0; i < NTL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = tot[i][e] = 0.f;
    // the list's pieces [j0, j1): f32, one piece; bf16, the entries of one
    // chunk of the window each
    for (int j0 = 0; j0 < n;) {
      int j1 = n;
      if constexpr (BF) {
        const int cid = (lp[j0] - ws) / chunk;
        for (j1 = j0 + 1; j1 < n && (lp[j1] - ws) / chunk == cid;) ++j1;
      }
      const int nks = (j1 - j0 + KS - 1) / KS;
      for (int ks = 0; ks < nks; ++ks) {
        int p[R];
        bool v[R];
        float w[2][R];  // kernel points g, g + 8 by the lane's rows
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int j = j0 + (BF ? ks * 16 + 2 * t + (i & 1) + 8 * (i >> 1) : ks * 8 + t + 4 * i);
          v[i] = j < j1;
          p[i] = v[i] ? lp[j] : 0;
          w[0][i] = w[1][i] = 0.f;
          if (v[i]) {
            const float4 sr = s[p[i]];
            const float d2 = ldd[j];
            if (has0) w[0][i] = kp_weight(d2, sr, qq, k0x, k0y, k0z, kk0, inv_extent);
            if (has1) w[1][i] = kp_weight(d2, sr, qq, k1x, k1y, k1z, kk1, inv_extent);
          }
        }
        if constexpr (BF) {
          const unsigned a[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[1][0], w[1][1]),
                                 pack_bf16(w[0][2], w[0][3]), pack_bf16(w[1][2], w[1][3])};
          const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) {
            const int c = c0 + nt * 8 + g;
            bf16 e[R];
#pragma unroll
            for (int i = 0; i < R; ++i) e[i] = (v[i] && c < C) ? x[(size_t)p[i] * C + c] : zero;
            const unsigned b[2] = {pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3])};
            mma_bf16(acc[nt], a, b);
          }
        } else {
          unsigned ah[4], al[4];
          const float wa[4] = {w[0][0], w[1][0], w[0][1], w[1][1]};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(wa[i], ah[i], al[i]);
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) {
            const int c = c0 + nt * 8 + g;
            const float b0 = (v[0] && c < C) ? x[(size_t)p[0] * C + c] : 0.f;
            const float b1 = (v[1] && c < C) ? x[(size_t)p[1] * C + c] : 0.f;
            unsigned bh[2], bl[2];
            split_tf32(b0, bh[0], bl[0]);
            split_tf32(b1, bh[1], bl[1]);
            mma3(acc[nt], ah, al, bh, bl);
          }
        }
      }
      if constexpr (BF) {  // the piece rounded to bf16, added in f32
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[nt][e] = __fadd_rn(tot[nt][e], panel_round<T>(acc[nt][e]));
            acc[nt][e] = 0.f;
          }
      }
      j0 = j1;
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = g + 8 * (e >> 1), c = c0 + nt * 8 + 2 * t + (e & 1);
        if (k >= KP || c >= C) continue;
        if constexpr (BF) {
          const bf16 hi = __float2bfloat16_rn(tot[nt][e]);
          out[k * C + c] = hi;
          out_lo[k * C + c] = __float2bfloat16_rn(__fsub_rn(tot[nt][e], __bfloat162float(hi)));
        } else {
          out[k * C + c] = acc[nt][e];
        }
      }
    }
  }
  if (lane < ldw - KP * C) {  // row padding
    out[KP * C + lane] = from_f32<T>(0.f);
    if (BF) out_lo[KP * C + lane] = from_f32<T>(0.f);
  }
  list_density(lp, n, act, den + qi);
}

// Narrow inputs (C < SIMT_CMAX, the first conv's single feature): one thread
// per (query, kernel point), FP32 FMA over the list in ascending position,
// on the panel's values (bf16: the weights rounded to bf16, whose products
// with the bf16 features are exact, so each FMA rounds only its sum; each
// chunk's piece rounded to bf16 and the pieces added, as in the MMA
// kernel).
#define SIMT_CMAX 8
template <typename T>
__global__ void __launch_bounds__(256)
weighted_simt_kernel(const float4* __restrict__ q, const float4* __restrict__ s,
                     const T* __restrict__ x, const float* __restrict__ kp, int KP,
                     const int* __restrict__ lpos, const float* __restrict__ ld2,
                     const int* __restrict__ lcnt, const int* __restrict__ act, int nq, int C,
                     int ldw, float inv_extent, const int* __restrict__ starts, int tile,
                     int chunk, T* __restrict__ wtd, float* __restrict__ den) {
  constexpr bool BF = is_bf16<T>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int qi = i >> 4, k = i & 15;
  if (qi >= nq) return;
  const int n = lcnt[qi];
  const float4 qq = q[qi];
  const int* lp = lpos + (size_t)qi * LCAP;
  const float* ldd = ld2 + (size_t)qi * LCAP;
  T* out = wtd + (size_t)qi * ldw;
  T* out_lo = wtd + (size_t)(nq + qi) * ldw;  // bf16: the lo rows
  if (k < KP) {
    const float kx = kp[3 * k], ky = kp[3 * k + 1], kz = kp[3 * k + 2];
    const float kk = dot3(kx, ky, kz, kx, ky, kz);
    const int ws = BF ? starts[qi / tile] : 0;
    float acc[SIMT_CMAX], tot[SIMT_CMAX];
#pragma unroll
    for (int c = 0; c < SIMT_CMAX; ++c) acc[c] = tot[c] = 0.f;
    int cid = BF && n > 0 ? (lp[0] - ws) / chunk : 0;
    for (int j = 0; j < n; ++j) {
      const int p = lp[j];
      if (BF && (p - ws) / chunk != cid) {  // a new chunk: round the last piece
        cid = (p - ws) / chunk;
#pragma unroll
        for (int c = 0; c < SIMT_CMAX; ++c) {
          tot[c] = __fadd_rn(tot[c], panel_round<T>(acc[c]));
          acc[c] = 0.f;
        }
      }
      const float w =
          panel_round<T>(kp_weight(ldd[j], s[p], qq, kx, ky, kz, kk, inv_extent));
#pragma unroll
      for (int c = 0; c < SIMT_CMAX; ++c)
        if (c < C) acc[c] = __fmaf_rn(w, to_f32(x[(size_t)p * C + c]), acc[c]);
    }
#pragma unroll
    for (int c = 0; c < SIMT_CMAX; ++c) {
      if (c >= C) continue;
      if constexpr (BF) {
        const float sum = __fadd_rn(tot[c], panel_round<T>(acc[c]));
        const bf16 hi = __float2bfloat16_rn(sum);
        out[k * C + c] = hi;
        out_lo[k * C + c] = __float2bfloat16_rn(__fsub_rn(sum, __bfloat162float(hi)));
      } else {
        out[k * C + c] = acc[c];
      }
    }
  }
  if (k == 0) {
    for (int c = KP * C; c < ldw; ++c) {  // row padding
      out[c] = from_f32<T>(0.f);
      if (BF) out_lo[c] = from_f32<T>(0.f);
    }
    int a = 0;
    for (int j = 0; j < n; ++j) a += act[lp[j]];
    den[qi] = fmaxf((float)a, 1.f);
  }
}

// weighted rows [nq, ldw] (ldw >= KP * C, padding zero; bf16: [2 * nq,
// ldw], the hi rows then the lo rows, the pieces cut at the chunks of
// `chunk` rows from each tile's window start starts[q / tile]) and the
// densities (act: row_active_kernel's flags)
template <typename T>
static inline cudaError_t weighted_rows(const void* q, const void* s, const T* x,
                                        const void* kp, int KP, const void* lpos,
                                        const void* ld2, const void* lcnt, const int* act,
                                        int nq, int C, int ldw, float inv_extent,
                                        const int* starts, int tile, int chunk, T* wtd,
                                        float* den, cudaStream_t st) {
  if (nq == 0) return cudaSuccess;
  if (is_bf16<T> && (!starts || tile < 1 || chunk < 1)) return cudaErrorInvalidValue;
#define W_ARGS                                                                             \
  (const float4*)q, (const float4*)s, x, (const float*)kp, KP, (const int*)lpos,            \
      (const float*)ld2, (const int*)lcnt, act, nq, C, ldw, inv_extent, starts, tile,      \
      chunk, wtd, den
  const unsigned warps = (unsigned)((nq + 7) / 8);
  if (C < SIMT_CMAX)
    weighted_simt_kernel<T><<<(unsigned)((nq * 16 + 255) / 256), 256, 0, st>>>(W_ARGS);
  else if (C <= 8) weighted_mma_kernel<T, 1><<<warps, 256, 0, st>>>(W_ARGS);
  else if (C <= 16) weighted_mma_kernel<T, 2><<<warps, 256, 0, st>>>(W_ARGS);
  else if (C <= 32) weighted_mma_kernel<T, 4><<<warps, 256, 0, st>>>(W_ARGS);
  else if (C <= 64) weighted_mma_kernel<T, 8><<<warps, 256, 0, st>>>(W_ARGS);
  else weighted_mma_kernel<T, 16><<<warps, 256, 0, st>>>(W_ARGS);
#undef W_ARGS
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm3: out[z] = sum over k in slice z of A(m, k) B(k, n)
// ---------------------------------------------------------------------------

#define GBK 32       // reduction depth of a shared-memory stage
#define GTHREADS 128 // 4 warps, 2 x 2 over the CTA tile

// A(m, k) = A[m * lda + k] (A_K) or A[k * lda + m]; B(k, n) = B[k * ldb + n]
// (B_N) or, the reduction cut into blocks of kblock (a multiple of V, the
// panel elements in 16 bytes: 4 floats, 8 bf16),
// B[(k / kblock) * kstride + n * ldb + k % kblock] (kblock >= K: plain
// B[n * ldb + k]). The contiguous dimension of each operand is
// read in 16-byte cp.async chunks, double-buffered; a chunk that starts
// inside the matrix must lie inside the allocation (leading dimensions and
// row paddings are multiples of V; K's padding, where a chunk of a
// K-contiguous operand overhangs K, must be zero). Slice z covers the
// reduction indices [z * kc, min((z + 1) * kc, K)), kc a multiple of GBK,
// and writes out + z * zstride (ldc); rows are divided by rowdiv[m] when
// it is given. With row_ptr (nondecreasing, [M + 1]), a tile whose rows
// all have row_ptr[m] == row_ptr[m + 1] holds zero rows of A: it writes
// zeros without reading anything.
template <typename T, int BM, int BN, bool A_K, bool B_N>
__global__ void __launch_bounds__(GTHREADS)
gemm3_kernel(const T* __restrict__ A, int lda, const T* __restrict__ B, int ldb,
             int kblock, long long kstride, float* __restrict__ out, int ldc, long long zstride,
             int M, int N, int K, int kc, const float* __restrict__ rowdiv,
             const int* __restrict__ row_ptr) {
  constexpr bool BF = is_bf16<T>;
  constexpr int V = 16 / sizeof(T);  // panel elements in a 16-byte chunk
  constexpr int KS = BF ? 16 : 8;    // reduction depth of one MMA
  // padded shared rows: conflict-free fragments, 16-byte aligned rows
  constexpr int ALD = A_K ? GBK + V : BM + 8;
  constexpr int BLD = B_N ? BN + 8 : GBK + V;
  constexpr int AS = A_K ? BM * ALD : GBK * ALD;
  constexpr int BS = B_N ? GBK * BLD : BN * BLD;
  constexpr int WM = BM / 2, WN = BN / 2, MT = WM / 16, NT = WN / 8;
  __shared__ __align__(16) T As[2][AS];
  __shared__ __align__(16) T Bs[2][BS];
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = (tid >> 5) >> 1, wn = (tid >> 5) & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const bool empty = row_ptr && row_ptr[m0] == row_ptr[min(m0 + BM, M)];
  const int nkt = kend > kbeg && !empty ? (kend - kbeg + GBK - 1) / GBK : 0;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto stage = [&](int kt) {
    const int k0 = kbeg + kt * GBK, buf = kt & 1;
    if (A_K) {
      for (int i = tid; i < BM * (GBK / V); i += GTHREADS) {
        const int m = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gm = m0 + m, gk = k0 + kq;
        const bool v = gm < M && gk < kend;
        cp_async16z(&As[buf][m * ALD + kq], v ? A + (size_t)gm * lda + gk : A, v);
      }
    } else {
      for (int i = tid; i < GBK * (BM / V); i += GTHREADS) {
        const int k = i / (BM / V), mq = (i % (BM / V)) * V;
        const int gm = m0 + mq, gk = k0 + k;
        const bool v = gm < M && gk < kend;
        cp_async16z(&As[buf][k * ALD + mq], v ? A + (size_t)gk * lda + gm : A, v);
      }
    }
    if (B_N) {
      for (int i = tid; i < GBK * (BN / V); i += GTHREADS) {
        const int k = i / (BN / V), nq = (i % (BN / V)) * V;
        const int gn = n0 + nq, gk = k0 + k;
        const bool v = gn < N && gk < kend;
        cp_async16z(&Bs[buf][k * BLD + nq], v ? B + (size_t)gk * ldb + gn : B, v);
      }
    } else {
      for (int i = tid; i < BN * (GBK / V); i += GTHREADS) {
        const int n = i / (GBK / V), kq = (i % (GBK / V)) * V;
        const int gn = n0 + n, gk = k0 + kq;
        const bool v = gn < N && gk < kend;
        const T* src = B + (size_t)(gk / kblock) * kstride + (size_t)gn * ldb + gk % kblock;
        cp_async16z(&Bs[buf][n * BLD + kq], v ? src : B, v);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (nkt > 0) stage(0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      stage(kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const T* as = As[kt & 1];
    const T* bs = Bs[kt & 1];
    // the stage's products in their own accumulators: over a long
    // reduction the truncation of the tensor cores' additions would grow
    float st[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) st[i][j][0] = st[i][j][1] = st[i][j][2] = st[i][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += KS) {
      if constexpr (BF) {
        // fragment pairs of consecutive k: one 32-bit load where k is the
        // contiguous dimension, two 16-bit loads packed where it is not
        const int k = kk + 2 * t;
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * WM + mt * 16 + g;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = r + 8 * (i & 1), k2 = k + 8 * (i >> 1);
            a[mt][i] = A_K ? load_pair(as + rr * ALD + k2)
                           : pack_bf16(as[k2 * ALD + rr], as[(k2 + 1) * ALD + rr]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = wn * WN + nt * 8 + g;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int k2 = k + 8 * i;
            b[nt][i] = B_N ? pack_bf16(bs[k2 * BLD + n], bs[(k2 + 1) * BLD + n])
                           : load_pair(bs + n * BLD + k2);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(st[mt][nt], a[mt], b[nt]);
      } else {
        const int k = kk + t;
        unsigned ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * WM + mt * 16 + g;
          float v[4];
          if (A_K) {
            v[0] = as[r * ALD + k];
            v[1] = as[(r + 8) * ALD + k];
            v[2] = as[r * ALD + k + 4];
            v[3] = as[(r + 8) * ALD + k + 4];
          } else {
            v[0] = as[k * ALD + r];
            v[1] = as[k * ALD + r + 8];
            v[2] = as[(k + 4) * ALD + r];
            v[3] = as[(k + 4) * ALD + r + 8];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mt][i], al[mt][i]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = wn * WN + nt * 8 + g;
          const float u0 = B_N ? bs[k * BLD + n] : bs[n * BLD + k];
          const float u1 = B_N ? bs[(k + 4) * BLD + n] : bs[n * BLD + k + 4];
          split_tf32(u0, bh[nt][0], bl[nt][0]);
          split_tf32(u1, bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma3(st[mt][nt], ah[mt], al[mt], bh[nt], bl[nt]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], st[i][j][e]);
    __syncthreads();
  }

  float* o = out + blockIdx.z * zstride;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      const float d = rowdiv ? rowdiv[row] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * WN + nt * 8 + 2 * t + e;
          if (col < N) {
            const float v = acc[mt][nt][2 * h + e];
            o[(size_t)row * ldc + col] = rowdiv ? __fdiv_rn(v, d) : v;
          }
        }
      }
    }
  }
}

// out[m][n] = (part[0][m][n] + part[1][m][n] + ...) in slice order, then
// divided by rowdiv[m] when it is given
__global__ void sum_slices_kernel(const float* __restrict__ part, int splits, int M, int N,
                                  float* __restrict__ out, int ldc,
                                  const float* __restrict__ rowdiv) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float v = part[i];
  for (int z = 1; z < splits; ++z) v = __fadd_rn(v, part[(size_t)z * mn + i]);
  const int m = (int)(i / N), n = (int)(i % N);
  out[(size_t)m * ldc + n] = rowdiv ? __fdiv_rn(v, rowdiv[m]) : v;
}

// out [M, N] (ldc) = A B over K, in `splits` slices of kc (partial sums in
// part [splits, M, N] when splits > 1), rows divided by rowdiv if given;
// kblock / kstride (0: one block) and row_ptr as in gemm3_kernel
template <typename T, bool A_K, bool B_N>
static cudaError_t gemm3(const T* A, int lda, const T* B, int ldb, float* out, int ldc,
                         int M, int N, int K, int splits, int kc, float* part,
                         const float* rowdiv, cudaStream_t st, int kblock = 0,
                         long long kstride = 0, const int* row_ptr = nullptr) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (splits > 1 && !part) return cudaErrorInvalidValue;
  if (kblock <= 0) kblock = K > 0 ? K : 1;
  float* dst = splits > 1 ? part : out;
  const int dld = splits > 1 ? N : ldc;
  const long long zs = (long long)M * N;
  const float* div = splits > 1 ? nullptr : rowdiv;
  if (N <= 32) {
    const dim3 grid((N + 31) / 32, (M + 63) / 64, splits);
    gemm3_kernel<T, 64, 32, A_K, B_N><<<grid, GTHREADS, 0, st>>>(A, lda, B, ldb, kblock,
                                                                 kstride, dst, dld, zs, M, N, K, kc, div,
                                                              row_ptr);
  } else {
    const dim3 grid((N + 63) / 64, (M + 63) / 64, splits);
    gemm3_kernel<T, 64, 64, A_K, B_N><<<grid, GTHREADS, 0, st>>>(A, lda, B, ldb, kblock,
                                                                 kstride, dst, dld, zs, M, N, K, kc, div,
                                                              row_ptr);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = (size_t)M * N;
  sum_slices_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(part, splits, M, N, out, ldc,
                                                                  rowdiv);
  return cudaGetLastError();
}
